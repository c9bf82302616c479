// Kernels K4, K5 and K6 for bra class (dd| against every ket class
// from (dd| on (design in eri4c.cuh, launches in eri4c_launch.cuh).
#include "eri4c_launch.cuh"

JC_ERI4C_BRA(2, 2, JC_KETS_FROM_22)
