// Kernel K9 instances of the classes (pd), (dd), (sf), (pf) (see oei.cuh,
// oei_launch.cuh).
#include "oei_launch.cuh"

JC_STV_CLASS(1, 2)
JC_STV_CLASS(2, 2)
JC_STV_CLASS(0, 3)
JC_STV_CLASS(1, 3)
