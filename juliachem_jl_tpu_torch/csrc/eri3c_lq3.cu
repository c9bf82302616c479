// Kernel K1 instances for aux shells of angular momentum 3, double and
// float output (see eri3c.cuh,
// eri3c_launch.cuh).
#include "eri3c_launch.cuh"

JC_ERI3C_LQ(3)
