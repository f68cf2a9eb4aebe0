"""CPU-side CUDA launch calls a request, the geometry's included."""

from benchmark.harness.readers import launches_per_step as read  # noqa: F401
