"""The benchmark's yardstick for work: the peaks of the card, the FLOPs of
a model step counted from its shapes, and each hand-written kernel's
least time (its roofline bound) from the shapes of one launch.

A bound is the larger of the launch's FLOPs over the peak and its bytes
over the memory bandwidth, with each input byte read once and each output
byte written once. The counts here are the benchmark's own, so a rewrite
of a kernel cannot change what its roofline share is measured against.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, dense: FLOP/s by precision, HBM bytes/s
PEAK_FLOPS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12, "fp16": 989e12,
              "int8": 1979e12, "fp8": 1979e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, flops: float, peak_flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / peak_flops)


def softargmax_fwd_bound_s(n: int, h: int, w: int, joints: int,
                           elt: int) -> float:
    """K1 on (n, h, w, joints) logits of `elt` bytes: the logits read once,
    (x, y) and four fp32 statistics a joint written once; about 6 fp32
    operations a logit."""
    numel = n * h * w * joints
    return bound_s(numel * elt + n * joints * 6 * 4, 6 * numel,
                   PEAK_FLOPS["fp32"])


def softargmax_bwd_bound_s(n: int, h: int, w: int, joints: int,
                           elt: int) -> float:
    """K2: the logits read and their gradient written once, the cotangent
    and statistics read once; about 12 fp32 operations a logit."""
    numel = n * h * w * joints
    return bound_s(2 * numel * elt + n * joints * 6 * 4, 12 * numel,
                   PEAK_FLOPS["fp32"])


def bottleneck_bound_s(n: int, cin: int, planes: int, downsample: bool,
                       h: int, w: int) -> float:
    """K3, one stride-1 bottleneck in bf16: x and the weights read once, the
    output written once; the block's convolutions at the bf16 peak."""
    cout = 4 * planes
    flops = 2 * n * h * w * planes * (
        cin + 9 * planes + cout + (cin * cout // planes if downsample else 0))
    wbytes = 2 * (cin * planes + 9 * planes * planes + planes * cout
                  + (cin * cout if downsample else 0))
    return bound_s(2 * n * h * w * (cin + cout) + wbytes, flops,
                   PEAK_FLOPS["bf16"])


def bottleneck_shape(cin: int):
    """(planes, downsample) of a stride-1 ResNet bottleneck whose input has
    cin channels: the first block of the first stage widens 64 to 256
    through a downsample; every other stride-1 block has cin = 4 planes."""
    return (64, True) if cin == 64 else (cin // 4, False)


def _meta_params(state_shapes):
    return {k: torch.empty(s, device="meta") for k, s in state_shapes.items()}


def forward_flops(kind: str, state_shapes, depth: int, batch: int,
                  size: int) -> int:
    """FLOPs of one forward of the reference network at `batch` samples of
    size x size: convolutions, transposed convolutions and the FTL
    products, counted on the meta device. kind: "cdr" (batch stereo
    pairs) or "2d" (batch images)."""
    from ..reference import model as ref
    params = _meta_params(state_shapes)
    ops = ref.Ops(params, params, train=False)
    if kind == "cdr":
        images = torch.empty((batch, 2, 3, size, size), device="meta")
        proj = torch.empty((batch, 2, 3, 4), device="meta")
        ref.cdrnet_heatmaps(ops, images, proj, depth)
    else:
        ref.poseresnet(ops, torch.empty((batch, 3, size, size),
                                        device="meta"), depth)
    return ops.flops
