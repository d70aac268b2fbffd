"""The port's hand-written CUDA kernels, their wrappers and plain versions.

The card's published peaks (H100 SXM, NVIDIA data sheet, dense), from which
a kernel's bound is the larger of its bytes over the memory rate and its
operations over the peak rate of their type.
"""

HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS = 989e12
TF32_TC_FLOPS = 495e12
FP32_FLOPS = 67e12
