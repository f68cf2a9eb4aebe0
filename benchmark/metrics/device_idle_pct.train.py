"""The device's idle share of a traced window of training steps."""

from benchmark.harness.readers import idle_pct as read  # noqa: F401
