"""fast3dhpe_tpu_torch: the PyTorch/CUDA port of fast3dhpe_tpu for one
NVIDIA H100.

It imports torch and numpy, never JAX or fast3dhpe_tpu. Entry points run
on the GPU unless the caller passes device="cpu" (device.py). The Pallas
kernels of the JAX package become kernels written for Hopper: the
soft-argmax forward in Triton (ops/softargmax.py) and the fused eval-mode
bottleneck in CUDA C++ (csrc/fused_bottleneck.cu, ops/bottleneck.py).
"""
