// Kernel K1 instances for aux shells of angular momentum 4, f32 output
// (see eri3c.cuh).
#include "eri3c.cuh"

JC_ERI3C_F32_LQ(4)
