"""CPU-side CUDA launch calls a training step (a graph replay counts one)."""

from benchmark.harness.readers import launches_per_step as read  # noqa: F401
