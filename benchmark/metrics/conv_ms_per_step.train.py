"""Device ms of cuDNN's and cuBLAS's convolution and matmul kernels a step."""

from benchmark.harness.readers import conv_ms_per_step as read  # noqa: F401
