"""K1 (soft-argmax forward): its launches' summed bound over their device time."""

from benchmark.harness.readers import k1_roofline_pct as read  # noqa: F401
