"""Model FLOPs (forward x 3) of the traced steps over the window times the peak."""

from benchmark.harness.readers import mfu_pct as read  # noqa: F401
