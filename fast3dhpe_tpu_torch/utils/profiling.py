"""Throughput meter and step traces. Port of
fast3dhpe_tpu/utils/profiling.py: `ThroughputMeter` and `StepTracer`
(through torch.profiler).

PyTorch returns from a CUDA call before the device finishes, so a host
clock measures compute only across a true synchronisation
(`torch.cuda.synchronize`, or a `.item()` of a result): the loops call
`ThroughputMeter.step` only after one.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch


class ThroughputMeter:
    """Rolling samples/s and step time over the last `window` steps."""

    def __init__(self, window: int = 50):
        self.window = window
        self.reset()

    def reset(self):
        self._times = []
        self._counts = []
        self._last: Optional[float] = None

    def start(self):
        self._last = time.perf_counter()

    def step(self, n_samples: int):
        """Record n_samples done since the last step (or start)."""
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            self._counts.append(n_samples)
            if len(self._times) > self.window:
                self._times.pop(0)
                self._counts.pop(0)
        self._last = now

    @property
    def samples_per_sec(self) -> float:
        if not self._times:
            return 0.0
        return sum(self._counts) / sum(self._times)


class StepTracer:
    """Traces steps 1-4 of a loop with torch.profiler (CPU, and CUDA where
    there is a card) into `<trace_dir>/trace.json`, a Chrome trace.

    A trace must never kill a run: every profiler call is guarded, and a
    failure disables the tracer for good.
    """

    def __init__(self, trace_dir, logger):
        self.trace_dir = trace_dir
        self.logger = logger
        self.prof = None
        self.done = trace_dir is None

    def maybe(self, step_i, m):
        if self.done:
            return
        try:
            if self.prof is None and step_i == 1:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                self.prof = torch.profiler.profile(activities=acts)
                self.prof.start()
            elif self.prof is not None and step_i >= 4:
                self.finish(m)
        except Exception as e:
            self.logger.warning("device trace failed: %s", e)
            self.prof, self.done = None, True

    def finish(self, m):
        if self.prof is None:
            return
        try:
            if m is not None:
                m["loss"].item()         # the traced steps' work, done
            self.prof.stop()
            os.makedirs(self.trace_dir, exist_ok=True)
            path = os.path.join(self.trace_dir, "trace.json")
            self.prof.export_chrome_trace(path)
            self.logger.info("Wrote device trace to %s", path)
        except Exception as e:
            self.logger.warning("device trace failed: %s", e)
        self.prof, self.done = None, True
