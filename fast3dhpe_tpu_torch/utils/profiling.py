"""Throughput meter, step traces and the replay floor. Port of
fast3dhpe_tpu/utils/profiling.py: `ThroughputMeter`, `StepTracer`
(through torch.profiler) and `measure_scan_floor`.

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


def measure_scan_floor(iters: int = 50, device="cuda") -> float:
    """Fixed cost (seconds) an iteration of a trivial step, as the JAX
    package measures its scan's (profiling.py:30-52): on CUDA a CUDA graph
    of one (8, 128) multiply-add, replayed `iters` times after a warm
    replay, timed from the first replay to a synchronisation; on the CPU
    the same op called `iters` times in a loop. What a replayed train step
    pays besides its work (train/graphs.py)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"measure_scan_floor: {device} asked for, but "
                           f"torch.cuda.is_available() is False")
    x = torch.zeros((8, 128), dtype=torch.float32, device=device)

    def body():
        x.mul_(1.0000001).add_(1e-9)

    if device.type != "cuda":
        body()
        t0 = time.perf_counter()
        for _ in range(iters):
            body()
        return (time.perf_counter() - t0) / iters
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    graph.replay()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        graph.replay()
    torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / iters


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
