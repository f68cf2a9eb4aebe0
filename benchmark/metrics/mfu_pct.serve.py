"""Model FLOPs (forward) of the traced requests over the window times the peak."""

from benchmark.harness.readers import mfu_pct as read  # noqa: F401
