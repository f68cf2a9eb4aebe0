"""fast3dhpe_tpu_torch: the PyTorch/CUDA port of fast3dhpe_tpu for one
NVIDIA H100.

It imports torch and numpy, never JAX or fast3dhpe_tpu. Entry points run
on the GPU unless the caller passes device="cpu" (device.py). The Pallas
kernels of the JAX package become kernels written for Hopper in CUDA C++:
the soft-argmax forward and backward (csrc/softargmax.cu,
ops/softargmax.py) and the fused eval-mode bottleneck
(csrc/fused_bottleneck.cu, ops/bottleneck.py). The input pipeline
(data/) runs on the frames' device with PyTorch's own ops, as the JAX
package runs it outside Pallas.
"""
