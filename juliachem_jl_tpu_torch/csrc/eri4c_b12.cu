// Kernels K4, K5 and K6 for bra class (pd| against every ket class
// from (pd| on (design in eri4c.cuh, launches in eri4c_launch.cuh).
#include "eri4c_launch.cuh"

JC_ERI4C_BRA(1, 2, JC_KETS_FROM_12)
