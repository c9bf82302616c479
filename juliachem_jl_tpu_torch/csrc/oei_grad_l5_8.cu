// Kernel K10 instances of the classes (pg), (df), (dg), (ff), (fg), (gg)
// (see oei_grad.cuh, oei_grad_launch.cuh).
#include "oei_grad_launch.cuh"

JC_STV_GRAD_CLASS(1, 4)
JC_STV_GRAD_CLASS(2, 3)
JC_STV_GRAD_CLASS(2, 4)
JC_STV_GRAD_CLASS(3, 3)
JC_STV_GRAD_CLASS(3, 4)
JC_STV_GRAD_CLASS(4, 4)
