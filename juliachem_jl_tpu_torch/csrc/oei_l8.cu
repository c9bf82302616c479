// Kernel K9 instances of the classes (gg) (see oei.cuh,
// oei_launch.cuh).
#include "oei_launch.cuh"

JC_STV_CLASS(4, 4)
