"""Soft-argmax forward (K1) and backward (K2) as Triton kernels, joined by
a torch.autograd.Function.

K1 replaces fast3dhpe_tpu/ops/pallas_softargmax.py `_softargmax_fwd_kernel`
(launched by `_fwd_pallas`, pallas_call at :64). For each (image, joint)
row of H*W logits: the max-subtracted fp32 softmax, then cx = sum p*x and
cy = sum p*y in heatmap pixels.

K2 replaces `_softargmax_bwd_kernel` (launched by `_bwd_pallas`,
pallas_call at :79): dL/dh = p * (gx*(x - cx) + gy*(y - cy)), with p, cx
and cy recomputed from the saved logits, as the JAX custom VJP does. The
backward saves the logits only; no probability tensor is kept.

What bounds them on the H100: each reads every logit once and does a few
operations on it, so the roofline is memory. At 64 images of 64x64x19,
fp32, K1 reads 19.9 MB (~6 us at 3.35 TB/s); K2 reads 19.9 MB and writes
19.9 MB (0.0119 ms). bf16 takes half of each.

The design: one program per (image, joint) row, the whole row of H*W
values in registers (BLOCK = next power of two, masked), strides passed
in, so the decoder's output (NCHW in channels_last memory, viewed as
NHWC) is read where it lies, with no copy. In that layout one row's
values lie J = 19 elements apart, so a program's loads and stores are
strided, not coalesced. Program ids run joint-fastest, so the 19 programs
that share each 128-byte line run side by side and the line comes from
HBM about once, the others hitting L2; the stores merge in L2 the same
way. That keeps the traffic near the bound, but each warp still issues a
transaction per element: this is what keeps K1 at 13-36x its bound and
K2 at 7-13x (PERF.md). K2 computes in fp32 and writes dh in the logits'
dtype, rounded once, with the logits' strides.
"""

# No `from __future__ import annotations` here: Triton reads the kernel's
# `tl.constexpr` annotation as an object.
import functools
import os

import torch

from ._build import BUILD_DIR
from .heatmap import soft_argmax, soft_argmax_bwd


@functools.lru_cache(maxsize=None)
def _kernels():
    global tl
    # Triton's compiled kernels go to build/ beside nvcc's, not to $HOME
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR.parent / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def softargmax_fwd(h_ptr, out_ptr, J, W, HW, s_n, s_h, s_w, s_j,
                       BLOCK: tl.constexpr):
        row = tl.program_id(0)
        n = row // J
        j = row - n * J
        base = n.to(tl.int64) * s_n + j.to(tl.int64) * s_j
        idx = tl.arange(0, BLOCK)
        mask = idx < HW
        y = idx // W
        x = idx - y * W
        v = tl.load(h_ptr + base + y * s_h + x * s_w, mask=mask,
                    other=float("-inf")).to(tl.float32)
        m = tl.max(v, axis=0)
        p = tl.where(mask, tl.exp(v - m), 0.0)
        s = tl.sum(p, axis=0)
        cx = tl.sum(p * x.to(tl.float32), axis=0) / s
        cy = tl.sum(p * y.to(tl.float32), axis=0) / s
        tl.store(out_ptr + row * 2, cx)
        tl.store(out_ptr + row * 2 + 1, cy)

    @triton.jit
    def softargmax_bwd(h_ptr, g_ptr, dh_ptr, J, W, HW, s_n, s_h, s_w, s_j,
                       BLOCK: tl.constexpr):
        row = tl.program_id(0)
        n = row // J
        j = row - n * J
        base = n.to(tl.int64) * s_n + j.to(tl.int64) * s_j
        idx = tl.arange(0, BLOCK)
        mask = idx < HW
        y = idx // W
        x = idx - y * W
        offs = base + y * s_h + x * s_w
        v = tl.load(h_ptr + offs, mask=mask,
                    other=float("-inf")).to(tl.float32)
        m = tl.max(v, axis=0)
        e = tl.where(mask, tl.exp(v - m), 0.0)
        p = e / tl.sum(e, axis=0)
        xf = x.to(tl.float32)
        yf = y.to(tl.float32)
        cx = tl.sum(p * xf, axis=0)
        cy = tl.sum(p * yf, axis=0)
        gx = tl.load(g_ptr + row * 2)
        gy = tl.load(g_ptr + row * 2 + 1)
        dh = p * (gx * (xf - cx) + gy * (yf - cy))
        tl.store(dh_ptr + offs, dh.to(dh_ptr.dtype.element_ty), mask=mask)

    return softargmax_fwd, softargmax_bwd, triton.next_power_of_2


def _check(name, heatmaps):
    if heatmaps.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {heatmaps.device}")
    if heatmaps.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: fp32 or bf16 logits, got {heatmaps.dtype}")
    if heatmaps.dim() != 4:
        raise ValueError(f"{name}: (N, H, W, J) logits, got shape "
                         f"{tuple(heatmaps.shape)}")


def _launch_args(heatmaps):
    N, H, W, J = heatmaps.shape
    return (N * J,), (J, W, H * W, *heatmaps.stride())


def soft_argmax_fwd_fused(heatmaps):
    """K1: (N, H, W, J) logits -> (N, J, 2) fp32 (x, y). The plain
    `soft_argmax` on a CPU tensor; on a CUDA tensor the Triton kernel."""
    _check("soft_argmax_fwd_fused", heatmaps)
    if heatmaps.device.type == "cpu":
        return soft_argmax(heatmaps)
    fwd, _, next_pow2 = _kernels()
    N, H, W, J = heatmaps.shape
    out = torch.empty((N, J, 2), dtype=torch.float32,
                      device=heatmaps.device)
    grid, args = _launch_args(heatmaps)
    fwd[grid](heatmaps, out, *args, BLOCK=next_pow2(H * W), num_warps=4)
    soft_argmax_fused.launches += 1
    return out


def soft_argmax_bwd_fused(heatmaps, g):
    """K2: the gradient of the soft-argmax for the cotangent g (N, J, 2),
    as (N, H, W, J) in the logits' dtype and strides. The plain
    `soft_argmax_bwd` on a CPU tensor; on a CUDA tensor the Triton
    kernel."""
    _check("soft_argmax_bwd_fused", heatmaps)
    N, H, W, J = heatmaps.shape
    if tuple(g.shape) != (N, J, 2):
        raise ValueError(f"soft_argmax_bwd_fused: cotangent of shape "
                         f"{(N, J, 2)}, got {tuple(g.shape)}")
    if heatmaps.device.type == "cpu":
        return soft_argmax_bwd(heatmaps, g)
    _, bwd, next_pow2 = _kernels()
    g = g.to(device=heatmaps.device, dtype=torch.float32).contiguous()
    dh = torch.empty_like(heatmaps)
    if dh.stride() != heatmaps.stride():
        raise ValueError(f"soft_argmax_bwd_fused: logits with overlapping "
                         f"or gapped strides {heatmaps.stride()}")
    grid, args = _launch_args(heatmaps)
    bwd[grid](heatmaps, g, dh, *args, BLOCK=next_pow2(H * W), num_warps=4)
    soft_argmax_bwd_fused.launches += 1
    return dh


class _SoftArgmax(torch.autograd.Function):
    """K1 forward, K2 backward from the saved logits (`_fused_fwd` /
    `_fused_bwd` in the JAX package)."""

    @staticmethod
    def forward(ctx, heatmaps):
        ctx.save_for_backward(heatmaps)
        return soft_argmax_fwd_fused(heatmaps)

    @staticmethod
    def backward(ctx, g):
        (heatmaps,) = ctx.saved_tensors
        return soft_argmax_bwd_fused(heatmaps, g)


def soft_argmax_fused(heatmaps):
    """(N, H, W, J) logits, fp32 or bf16, any strides -> (N, J, 2) fp32
    (x, y), differentiable.

    On a CPU tensor this runs the plain `soft_argmax` and `soft_argmax_bwd`;
    on a CUDA tensor it launches K1 (forward) and K2 (backward) or raises.
    `soft_argmax_fused.launches` counts K1 launches and
    `soft_argmax_bwd_fused.launches` K2 launches.
    """
    _check("soft_argmax_fused", heatmaps)
    return _SoftArgmax.apply(heatmaps)


soft_argmax_fused.launches = 0
soft_argmax_bwd_fused.launches = 0
