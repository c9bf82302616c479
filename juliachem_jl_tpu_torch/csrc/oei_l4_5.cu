// Kernel K9 instances of the classes (df), (sg), (pg) (see oei.cuh,
// oei_launch.cuh).
#include "oei_launch.cuh"

JC_STV_CLASS(2, 3)
JC_STV_CLASS(0, 4)
JC_STV_CLASS(1, 4)
