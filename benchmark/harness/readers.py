"""The arithmetic of the per-layer readers (benchmark/metrics/*.py). Each
takes a Trace (harness/trace.py) and returns the metric's value, or None
where the trace holds nothing for it to read: the harness then leaves the
metric out of the result."""

from __future__ import annotations

from . import flops
from .trace import CONV_KERNELS

K1, K2, K3 = "softargmax_fwd", "softargmax_bwd", "bottleneck_kernel"
K3_OP = "fast3dhpe::fused_bottleneck"


def idle_pct(trace):
    """The share of the window in which no operation ran on the device."""
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)


def mfu_pct(trace):
    """The model's FLOPs of the window's steps over the window times the
    peak of the cell's precision on the cell's cards."""
    info = trace.info
    peak = flops.PEAK_FLOPS[info["precision"]] * info["chips"]
    return 100.0 * info["flops_per_step"] * trace.steps / (
        trace.window_s * peak)


def launches_per_step(trace):
    return sum(trace.launches.values()) / trace.steps


def conv_ms_per_step(trace):
    return 1e3 * trace.kernel_s(*CONV_KERNELS) / trace.steps


def _share(bound_s, kernel):
    def read(trace):
        n = trace.count(kernel)
        if n == 0:
            return None
        return 100.0 * n * bound_s(trace.info) / trace.kernel_s(kernel)
    return read


def _heatmap(info):
    return info["heatmap"]          # (n, h, w, joints, bytes a logit)


k1_roofline_pct = _share(
    lambda info: flops.softargmax_fwd_bound_s(*_heatmap(info)), K1)
k2_roofline_pct = _share(
    lambda info: flops.softargmax_bwd_bound_s(*_heatmap(info)), K2)


def k3_roofline_pct(trace):
    """Each K3 launch's bound from the input shape of the operator that
    launched it, summed, over the launches' summed device time."""
    ops = [op for op in trace.cpu if op.name == K3_OP and op.shapes]
    n = trace.count(K3)
    if n == 0 or len(ops) != n:
        return None
    total = 0.0
    for op in ops:
        b, cin, h, w = op.shapes[0]
        total += flops.bottleneck_bound_s(b, cin, *flops.bottleneck_shape(cin),
                                          h, w)
    return 100.0 * total / trace.kernel_s(K3)
