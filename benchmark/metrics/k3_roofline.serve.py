"""K3 (fused bottleneck): each launch's bound from its input shape, over the device time."""

from benchmark.harness.readers import k3_roofline_pct as read  # noqa: F401
