// Kernels K4, K5 and K6 for bra class (pp| against every ket class
// from (pp| on (design in eri4c.cuh, launches in eri4c_launch.cuh).
#include "eri4c_launch.cuh"

JC_ERI4C_BRA(1, 1, JC_KETS_FROM_11)
