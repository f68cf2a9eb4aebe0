"""A traced window: torch.profiler around a fixed number of the cell's
steps, reduced to what the per-layer readers (benchmark/metrics/) read.

Device busy time is the union of the spans of every operation on the
device (kernels, NCCL's included, copies and fills), so that work on two
streams at once counts once. Host launches are the CPU-side CUDA calls
that put work on the device.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

# CPU-side CUDA calls that put work on the device
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")
# substrings of the names of cuDNN's and cuBLAS's convolution and matrix
# product kernels on Hopper
CONV_KERNELS = ("xmma", "cutlass", "nvjet", "cudnn", "gemm", "conv")
TOP = 10


@dataclass
class Op:
    name: str
    start: float          # us, the profiler's clock
    end: float
    shapes: list = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e6


@dataclass
class Trace:
    """kernels: the device's operations; cpu: the host's operations
    (with their input shapes); launches: {CUDA call: count}; steps: the
    steps or requests of the window; window_s: its length by the host's
    clock; info: the cell's shapes and peaks (the driver's `trace_info`)."""
    kernels: List[Op]
    cpu: List[Op]
    launches: Dict[str, int]
    steps: int
    window_s: float
    info: dict

    def busy_intervals(self) -> List[Tuple[float, float]]:
        out = []
        for a, b in sorted((k.start, k.end) for k in self.kernels):
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernel_s(self, *substrings) -> float:
        return sum(k.seconds for k in self.kernels
                   if any(s in k.name for s in substrings))

    def count(self, *substrings) -> int:
        return sum(1 for k in self.kernels
                   if any(s in k.name for s in substrings))


def record(fn, steps: int, info: dict, device) -> Trace:
    """Run fn() (`steps` steps) under torch.profiler, until the device is
    done, and reduce the profile to a Trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    sync()
    with profile(activities=activities, record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window_s = time.perf_counter() - t0
    kernels, cpu = [], []
    launches = defaultdict(int)
    for e in prof.events():
        if getattr(e, "is_user_annotation", False):
            continue
        op = Op(e.name, e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            kernels.append(op)
        elif e.device_type == DeviceType.CPU:
            if e.name in LAUNCH_CALLS:
                launches[e.name] += 1
            op.shapes = list(e.input_shapes or [])
            cpu.append(op)
    return Trace(kernels, cpu, dict(launches), steps, window_s, info)


def _host_at(host, starts, t, reach=4096):
    """The host operation of the latest start that covers time t: the
    innermost of those nested on one thread."""
    i = bisect.bisect_right(starts, t) - 1
    for op in host[max(i - reach, -1) + 1:i + 1][::-1]:
        if op.end >= t:
            return op.name
    return "no host operation"


def breakdown(trace: Trace) -> dict:
    """The device operations that took most time, by name, and the idle
    gaps between device operations summed by the innermost host operation
    running at each gap's middle."""
    by_name = defaultdict(float)
    for k in trace.kernels:
        by_name[k.name] += k.seconds
    busy = trace.busy_intervals()
    host = sorted((op for op in trace.cpu if op.name not in LAUNCH_CALLS),
                  key=lambda op: op.start)
    starts = [op.start for op in host]
    gaps = defaultdict(float)
    for (_, a), (b, _) in zip(busy, busy[1:]):
        gaps[_host_at(host, starts, (a + b) / 2)] += (b - a) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in idle]}
