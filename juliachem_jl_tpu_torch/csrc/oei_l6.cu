// Kernel K9 instances of the classes (ff), (dg) (see oei.cuh,
// oei_launch.cuh).
#include "oei_launch.cuh"

JC_STV_CLASS(3, 3)
JC_STV_CLASS(2, 4)
