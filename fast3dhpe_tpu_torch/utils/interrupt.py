"""Graceful shutdown for the training loops. Port of
fast3dhpe_tpu/utils/interrupt.py: a preempted machine gets SIGTERM first,
and turning it into KeyboardInterrupt lets a loop save `latest` (weights,
optimizer state, step, best metric) so that --resume continues there."""

from __future__ import annotations

import contextlib
import signal
import threading


@contextlib.contextmanager
def interruptible():
    """Within the block, SIGTERM raises KeyboardInterrupt (main thread
    only: elsewhere a signal handler cannot be installed; no-op then)."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    old = signal.getsignal(signal.SIGTERM)

    def _handler(signum, frame):
        raise KeyboardInterrupt("SIGTERM")

    signal.signal(signal.SIGTERM, _handler)
    try:
        yield
    finally:
        signal.signal(signal.SIGTERM, old)
