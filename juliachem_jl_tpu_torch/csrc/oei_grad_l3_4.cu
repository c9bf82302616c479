// Kernel K10 instances of the classes (pd), (pf), (sg), (dd)
// (see oei_grad.cuh, oei_grad_launch.cuh).
#include "oei_grad_launch.cuh"

JC_STV_GRAD_CLASS(1, 2)
JC_STV_GRAD_CLASS(1, 3)
JC_STV_GRAD_CLASS(0, 4)
JC_STV_GRAD_CLASS(2, 2)
