"""Soft-argmax forward (K1) and backward (K2): launch plan, launch rules,
ctypes binding and wrappers, registered as the PyTorch operators
fast3dhpe::soft_argmax and its backward fast3dhpe::soft_argmax_bwd.

The kernels are csrc/softargmax.cu (CUDA C++ for sm_90a, built by
ops/_build.py). K1 replaces fast3dhpe_tpu/ops/pallas_softargmax.py
`_softargmax_fwd_kernel` (:28, launched by `_fwd_pallas`, pallas_call at
:64): for each (image, joint) the max-subtracted fp32 softmax over H*W,
then cx = sum p*x and cy = sum p*y in heatmap pixels. K2 replaces
`_softargmax_bwd_kernel` (:45, launched by `_bwd_pallas`, pallas_call at
:79): dL/dh = p * (gx*(x - cx) + gy*(y - cy)). K1 also returns, per (image,
joint), the statistics (m, 1/S, cx, cy), and the operator's autograd saves
them beside the logits, so K2 reads the logits once; the JAX custom VJP
recomputes p, cx and cy from the logits instead.

What bounds them on the H100: memory. At 64 images of 64x64x19 K1 reads
19.9 MB in fp32 (6.0 us at 3.35 TB/s), 10.0 MB in bf16; K2 reads and
writes 19.9 MB each in fp32 (11.9 us).

The strided rows: the decoder's output (NCHW in channels_last memory,
viewed as NHWC) is a contiguous (N, H, W, J) tensor, in which one
(image, joint) row lies J = 19 elements apart but each image is one
contiguous span of H*W*J values. Both kernels stream that span in 16-byte
pieces and map each element to its (pixel, joint) themselves, so every
load and store covers whole sectors (the .cu's header says how). On a
CUDA tensor the wrappers take only that layout and raise on any other
(`check_launch`); on a CPU tensor they run the plain `soft_argmax` and
`soft_argmax_bwd` (ops/heatmap.py), which take any strides.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from .. import cuda_graphs
from ._build import load_library
from .heatmap import soft_argmax, soft_argmax_bwd

# the kernels' constants (csrc/softargmax.cu, which a CPU test holds these
# against): threads a CTA, most joints, pixels of a K1 thread's run, K1's
# ring depth, K1's chunk granularity in pixels, K1 CTAs an image (one
# cluster), 16-byte vectors a K2 thread loads at once, shared memory a
# block may use
_THREADS, _MAX_J, _RUN, _STAGES, _PIX_ALIGN, _MAX_CHUNKS, _BWD_VEC = (
    256, 64, 16, 3, 16, 8, 4)
_SMEM_LIMIT = 232448
_SMS = 132                      # streaming multiprocessors of an H100
_TARGET_CTAS = 2 * _SMS         # what a K1 grid should hold at most
_BWD_TARGET_CTAS = 8 * _SMS     # K2: a full wave of 256-thread CTAs
_DTYPES = (torch.float32, torch.bfloat16)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _ceil_div(a, b) * b


def tile_pix(joints: int) -> int:
    """Pixels of a K1 tile: one run for each group of threads that share a
    joint (the kernel's `tile_pix`)."""
    return (_THREADS // joints) * _RUN


def fwd_smem_bytes(joints: int, elt: int) -> int:
    """K1's dynamic shared memory (the kernel's `fwd_smem_bytes`): a ring
    of tiles, each a tile's bytes rounded up to 16 and one 16-byte piece
    more for a tile that starts off a 16-byte boundary."""
    return _STAGES * (_round_up(tile_pix(joints) * joints * elt, 16) + 16)


@dataclass(frozen=True)
class LaunchPlan:
    """The grids of one K1 and one K2 launch: (chunks, N) CTAs each."""
    chunk_pix: int       # K1: pixels a CTA, a multiple of _PIX_ALIGN
    chunks: int          # K1: CTAs an image
    bwd_chunk_vec: int   # K2: 16-byte vectors a CTA
    bwd_chunks: int      # K2: CTAs an image
    smem: int            # K1's dynamic shared memory, bytes


@functools.lru_cache(maxsize=64)
def launch_plan(n: int, hw: int, joints: int, elt: int) -> LaunchPlan:
    """Cut each image of hw pixels x `joints` values of `elt` bytes: K1
    into at most _MAX_CHUNKS chunks of whole pixels (one cluster an image)
    and at most two CTAs an SM; K2 into chunks of 16-byte vectors, so that
    its grid fills every SM with as many CTAs as it can hold at once,
    where the images allow (scripts/softargmax_plan_sweep.py)."""
    chunk_pix = _round_up(
        _ceil_div(hw, min(_MAX_CHUNKS, max(1, _TARGET_CTAS // n))),
        _PIX_ALIGN)
    nvec = hw * joints * elt // 16
    chunk_vec = _round_up(
        max(1, _ceil_div(nvec, _ceil_div(_BWD_TARGET_CTAS, n))), 32)
    return LaunchPlan(chunk_pix, _ceil_div(hw, chunk_pix), chunk_vec,
                      max(1, _ceil_div(nvec, chunk_vec)),
                      fwd_smem_bytes(joints, elt))


_RULES = ("device cpu or cuda", "dtype float32 or bfloat16",
          "4-d (N, H, W, J)")
_CUDA_RULES = (f"1 <= J <= {_MAX_J}", "1 <= N <= 65535", "H, W >= 1",
               "contiguous (N, H, W, J)", "16-byte aligned data_ptr")


def _dense(shape: Sequence[int], strides: Sequence[int]) -> bool:
    """torch's is_contiguous: row-major strides, any stride on a size-1
    dimension."""
    want = 1
    for size, stride in zip(reversed(shape), reversed(strides)):
        if size != 1 and stride != want:
            return False
        want *= size
    return True


def check_launch(device: str, dtype: torch.dtype, shape: Sequence[int],
                 strides: Sequence[int], data_ptr: int) -> None:
    """The wrappers' rules on the logits. On the CPU: a known device, fp32
    or bf16, 4-d. On CUDA also what the kernels read: J <= 64, the grid's
    N, a contiguous (N, H, W, J) tensor (the decoder's channels_last output
    viewed as NHWC) at a 16-byte aligned address. Raises ValueError naming
    the rules and the ones broken."""
    ok = [device in ("cpu", "cuda"), dtype in _DTYPES, len(shape) == 4]
    rules = list(_RULES)
    if device == "cuda" and len(shape) == 4:
        n, h, w, j = shape
        rules += _CUDA_RULES
        ok += [1 <= j <= _MAX_J, 1 <= n <= 65535, h >= 1 and w >= 1,
               _dense(shape, strides), data_ptr % 16 == 0]
    if not all(ok):
        broken = [r for r, good in zip(rules, ok) if not good]
        raise ValueError(
            f"soft_argmax: the logits must have {', '.join(rules)}; got "
            f"{device} {dtype} shape {tuple(shape)} strides "
            f"{tuple(strides)}; broken: {', '.join(broken)}")


def _check(heatmaps):
    """check_launch on a tensor. While torch.export traces, the tensor has
    no data: its address is checked when the traced call runs (in the
    CUDA implementation, which checks again)."""
    dev = heatmaps.device.type
    real = dev == "cuda" and not torch.compiler.is_compiling()
    check_launch(dev, heatmaps.dtype, tuple(heatmaps.shape),
                 heatmaps.stride(), heatmaps.data_ptr() if real else 0)


@functools.lru_cache(maxsize=None)
def _entries():
    lib = load_library("softargmax")
    fwd, bwd = lib.softargmax_fwd, lib.softargmax_bwd
    fwd.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
                    + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    bwd.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                    + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _fwd_cuda(heatmaps, plan: LaunchPlan):
    """One K1 launch on checked CUDA logits, cut as `plan` says."""
    N, H, W, J = heatmaps.shape
    dev = heatmaps.device
    out = torch.empty((N, J, 2), dtype=torch.float32, device=dev)
    stats = torch.empty((N, J, 4), dtype=torch.float32, device=dev)
    err = _entries()[0](
        _ptr(heatmaps), int(heatmaps.dtype == torch.bfloat16), _ptr(out),
        _ptr(stats), N, H * W, W, J, plan.chunk_pix, plan.chunks,
        _stream(dev))
    if err:
        raise RuntimeError(f"soft_argmax forward: CUDA error {err} at "
                           f"launch")
    return out, stats


def _bwd_cuda(heatmaps, stats, g, plan: LaunchPlan):
    """One K2 launch on checked CUDA logits, statistics and fp32
    contiguous g, cut as `plan` says."""
    N, H, W, J = heatmaps.shape
    dh = torch.empty_like(heatmaps)
    err = _entries()[1](
        _ptr(heatmaps), int(heatmaps.dtype == torch.bfloat16), _ptr(stats),
        _ptr(g), _ptr(dh), N, H * W, W, J, plan.bwd_chunk_vec,
        plan.bwd_chunks, _stream(heatmaps.device))
    if err:
        raise RuntimeError(f"soft_argmax backward: CUDA error {err} at "
                           f"launch")
    return dh


def _plan_of(heatmaps) -> LaunchPlan:
    N, H, W, J = heatmaps.shape
    return launch_plan(N, H * W, J, heatmaps.element_size())


def _plain_stats(heatmaps, out):
    """K1's statistics (m, 1/S, cx, cy) in plain PyTorch, fp32."""
    h = heatmaps.float()
    N, H, W, J = h.shape
    flat = h.reshape(N, H * W, J)
    m = flat.amax(dim=1)
    s = (flat - m[:, None]).exp().sum(dim=1)
    return torch.stack([m, 1.0 / s, out[..., 0], out[..., 1]], dim=-1)


# K1 and K2 as registered operators, so that torch.export (whose fake
# tensors have no data_ptr) traces them and an exported graph calls them:
# the CPU implementation is the plain version, the CUDA one the kernel
# (which raises on what it does not take), and K2 is K1's backward.

@torch.library.custom_op("fast3dhpe::soft_argmax", mutates_args=(),
                         device_types="cpu")
def _k1_op(heatmaps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    out = soft_argmax(heatmaps)
    return out, _plain_stats(heatmaps, out)


@_k1_op.register_kernel("cuda")
def _k1_cuda(heatmaps):
    _check(heatmaps)
    out = _fwd_cuda(heatmaps, _plan_of(heatmaps))
    soft_argmax_fused.launches += 1
    return out


@_k1_op.register_fake
def _k1_fake(heatmaps):
    N, _, _, J = heatmaps.shape
    return (heatmaps.new_empty((N, J, 2), dtype=torch.float32),
            heatmaps.new_empty((N, J, 4), dtype=torch.float32))


@torch.library.custom_op("fast3dhpe::soft_argmax_bwd", mutates_args=(),
                         device_types="cpu")
def _k2_op(heatmaps: torch.Tensor, stats: torch.Tensor,
           g: torch.Tensor) -> torch.Tensor:
    dh = torch.empty_like(heatmaps)
    dh.copy_(soft_argmax_bwd(heatmaps, g))
    return dh


@_k2_op.register_kernel("cuda")
def _k2_cuda(heatmaps, stats, g):
    _check(heatmaps)
    N, H, W, J = heatmaps.shape
    dev = heatmaps.device
    if (tuple(stats.shape) != (N, J, 4) or stats.dtype != torch.float32
            or stats.device != dev or not stats.is_contiguous()):
        raise ValueError(f"soft_argmax_bwd_fused: statistics must be a "
                         f"contiguous (N, J, 4) float32 tensor on {dev}")
    g = g.to(device=dev, dtype=torch.float32).contiguous()
    dh = _bwd_cuda(heatmaps, stats, g, _plan_of(heatmaps))
    soft_argmax_bwd_fused.launches += 1
    return dh


@_k2_op.register_fake
def _k2_fake(heatmaps, stats, g):
    return torch.empty_like(heatmaps)


def _k1_setup(ctx, inputs, output):
    ctx.save_for_backward(inputs[0], output[1])


def _k1_backward(ctx, g, _g_stats):
    heatmaps, stats = ctx.saved_tensors
    if g is None:
        g = heatmaps.new_zeros((heatmaps.shape[0], heatmaps.shape[3], 2),
                               dtype=torch.float32)
    return _k2_op(heatmaps, stats, g)


_k1_op.register_autograd(_k1_backward, setup_context=_k1_setup)


def soft_argmax_fwd_fused(heatmaps) -> Tuple[torch.Tensor,
                                             Optional[torch.Tensor]]:
    """K1: (N, H, W, J) logits -> ((N, J, 2) fp32 (x, y), statistics).

    On a CPU tensor: the plain `soft_argmax`, any strides, and no
    statistics (None). On a CUDA tensor: csrc/softargmax.cu, whose
    statistics are (N, J, 4) fp32 (m, 1/S, cx, cy) for K2; or it raises.
    `soft_argmax_fused.launches` counts its launches.
    """
    _check(heatmaps)
    if heatmaps.device.type == "cpu":
        return soft_argmax(heatmaps), None
    return _k1_op(heatmaps)


def soft_argmax_stats(heatmaps) -> torch.Tensor:
    """K1's statistics of (N, H, W, J) logits: (N, J, 4) fp32 (m, 1/S, cx,
    cy), m the max over H*W, S the sum of exp(logit - m), (cx, cy) the
    soft-argmax, through fast3dhpe::soft_argmax on either device: on a CPU
    tensor the plain version (`_plain_stats`), on a CUDA tensor one K1
    launch (counted in `soft_argmax_fused.launches`), or it raises.
    Statistics of row blocks combine exactly into those of the whole
    heatmap (parallel/spatial.py split_soft_argmax)."""
    _check(heatmaps)
    return _k1_op(heatmaps)[1]


def soft_argmax_bwd_fused(heatmaps, g, stats=None):
    """K2: the gradient of the soft-argmax for the cotangent g (N, J, 2),
    as (N, H, W, J) in the logits' dtype and strides.

    On a CPU tensor: the plain `soft_argmax_bwd`, any strides (`stats` is
    not read). On a CUDA tensor: csrc/softargmax.cu from K1's statistics,
    running K1 first (and counting it) when `stats` is None; or it raises.
    `soft_argmax_bwd_fused.launches` counts K2's launches.
    """
    _check(heatmaps)
    N, H, W, J = heatmaps.shape
    if tuple(g.shape) != (N, J, 2):
        raise ValueError(f"soft_argmax_bwd_fused: cotangent of shape "
                         f"{(N, J, 2)}, got {tuple(g.shape)}")
    if heatmaps.device.type == "cpu":
        return soft_argmax_bwd(heatmaps, g)
    if stats is None:
        _, stats = soft_argmax_fwd_fused(heatmaps)
    return _k2_op(heatmaps, stats, g)


def soft_argmax_fused(heatmaps):
    """(N, H, W, J) logits, fp32 or bf16 -> (N, J, 2) fp32 (x, y),
    differentiable, through the registered operator fast3dhpe::soft_argmax
    (K2, fast3dhpe::soft_argmax_bwd, is its backward; the JAX custom VJP
    recomputes p, cx and cy from the logits, K2 reads K1's statistics).

    On a CPU tensor this runs the plain `soft_argmax` and `soft_argmax_bwd`
    (any strides); on a CUDA tensor it launches K1 (forward) and K2
    (backward) on a contiguous (N, H, W, J) tensor, or raises.
    `soft_argmax_fused.launches` counts K1 launches and
    `soft_argmax_bwd_fused.launches` K2 launches.
    """
    _check(heatmaps)
    return _k1_op(heatmaps)[0]


cuda_graphs.carry("soft_argmax", soft_argmax_fused)
cuda_graphs.carry("soft_argmax_bwd", soft_argmax_bwd_fused)
