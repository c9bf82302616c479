// Kernel K1 instances for aux shells of angular momentum 3 (see eri3c.cuh).
#include "eri3c.cuh"

JC_ERI3C_LQ(3)
