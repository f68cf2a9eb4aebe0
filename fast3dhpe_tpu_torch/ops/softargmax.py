"""Soft-argmax forward as a Triton kernel.

Replaces fast3dhpe_tpu/ops/pallas_softargmax.py `_softargmax_fwd_kernel`
(launched by `_fwd_pallas`, pallas_call at :64). For each (image, joint)
row of H*W logits: the max-subtracted fp32 softmax, then cx = sum p*x and
cy = sum p*y in heatmap pixels.

What bounds it on the H100: it reads each logit once and does a few
operations on it, so the roofline is memory (19.9 MB of fp32 for 64 images
of 64x64x19, ~6 us at 3.35 TB/s; half that from bf16). The design reads
the decoder's bf16 output where it lies: one program per (image, joint)
row, the whole row of H*W values in one block (BLOCK = next power of two,
masked), strides passed in, so a channels_last heatmap needs no copy to
NCHW. Max, exp-sum and the two weighted sums run in fp32 registers.
"""

# No `from __future__ import annotations` here: Triton reads the kernel's
# `tl.constexpr` annotation as an object.
import functools
import os

import torch

from ._build import BUILD_DIR
from .heatmap import soft_argmax


@functools.lru_cache(maxsize=None)
def _kernel():
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

    return softargmax_fwd, triton.next_power_of_2


def soft_argmax_fused(heatmaps):
    """(N, H, W, J) logits, fp32 or bf16, any strides -> (N, J, 2) fp32
    (x, y).

    On a CPU tensor this runs the plain `soft_argmax`; on a CUDA tensor it
    launches the Triton kernel or raises.
    """
    if heatmaps.device.type == "cpu":
        return soft_argmax(heatmaps)
    if heatmaps.device.type != "cuda":
        raise ValueError(f"soft_argmax_fused: unsupported device "
                         f"{heatmaps.device}")
    if heatmaps.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"soft_argmax_fused: fp32 or bf16 logits, got "
                        f"{heatmaps.dtype}")
    if heatmaps.dim() != 4:
        raise ValueError(f"soft_argmax_fused: (N, H, W, J) logits, got shape "
                         f"{tuple(heatmaps.shape)}")
    N, H, W, J = heatmaps.shape
    kernel, next_pow2 = _kernel()
    out = torch.empty((N, J, 2), dtype=torch.float32,
                      device=heatmaps.device)
    s_n, s_h, s_w, s_j = heatmaps.stride()
    kernel[(N * J,)](heatmaps, out, J, W, H * W, s_n, s_h, s_w, s_j,
                     BLOCK=next_pow2(H * W), num_warps=4)
    soft_argmax_fused.launches += 1
    return out


soft_argmax_fused.launches = 0
