// Kernel K9 instances of the classes (ss), (sp), (sd), (pp) (see oei.cuh,
// oei_launch.cuh).
#include "oei_launch.cuh"

JC_STV_CLASS(0, 0)
JC_STV_CLASS(0, 1)
JC_STV_CLASS(0, 2)
JC_STV_CLASS(1, 1)
