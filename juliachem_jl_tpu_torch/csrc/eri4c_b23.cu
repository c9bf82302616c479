// Kernels K4, K5 and K6 for bra class (df| against every ket class
// from (df| on (design in eri4c.cuh, launches in eri4c_launch.cuh).
#include "eri4c_launch.cuh"

JC_ERI4C_BRA(2, 3, JC_KETS_FROM_23)
