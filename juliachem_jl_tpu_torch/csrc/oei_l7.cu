// Kernel K9 instances of the classes (fg) (see oei.cuh,
// oei_launch.cuh).
#include "oei_launch.cuh"

JC_STV_CLASS(3, 4)
