// Kernels K4, K5 and K6 for bra class (fg| against every ket class
// from (fg| on (design in eri4c.cuh, launches in eri4c_launch.cuh).
#include "eri4c_launch.cuh"

JC_ERI4C_BRA(3, 4, JC_KETS_FROM_34)
