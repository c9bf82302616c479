// Kernel K11 3-center instances with an aux shell of l = 4: the 15
// primary pair classes (see eri3c_grad.cuh, eri3c_grad_launch.cuh).
#include "eri3c_grad_launch.cuh"

JC_ERI3C_GRAD_PAIRS(4)
