// Kernel K10 instances of the classes (ss), (sp), (sd), (pp), (sf)
// (see oei_grad.cuh, oei_grad_launch.cuh).
#include "oei_grad_launch.cuh"

JC_STV_GRAD_CLASS(0, 0)
JC_STV_GRAD_CLASS(0, 1)
JC_STV_GRAD_CLASS(0, 2)
JC_STV_GRAD_CLASS(1, 1)
JC_STV_GRAD_CLASS(0, 3)
