"""K2 (soft-argmax backward): its launches' summed bound over their device time."""

from benchmark.harness.readers import k2_roofline_pct as read  # noqa: F401
