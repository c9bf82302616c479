// Kernel K1 instances for aux shells of angular momentum 1, f32 output
// (see eri3c.cuh).
#include "eri3c.cuh"

JC_ERI3C_F32_LQ(1)
