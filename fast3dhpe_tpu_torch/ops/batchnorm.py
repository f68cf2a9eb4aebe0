"""Train-mode BatchNorm, forward and backward: the plain version, the launch
plans of csrc/batchnorm.cu, its ctypes binding, and the wrappers that
models/layers.py `_MaskedBatchNorm` calls.

What is computed (the class docstring of `_MaskedBatchNorm` says why):
flax's masked batch statistics in fp32 over the valid rows x positions,
var = max(E[x^2] - E[x]^2, 0), y = (x - mean) * (rsqrt(var + eps) * w) + b
over every row in x.dtype, and the closed-form backward of that, gradients
through the statistics included. Under a process group one packed
all_reduce of (s1, s2, count) sits between the statistics and the
normalisation, and one of (s, dbias) between the backward's reduction and
dx; dweight and dbias stay the rank's share.

On a CPU tensor the wrappers run `plain_forward` / `plain_backward`, eager
PyTorch. On a CUDA tensor they launch the kernels (csrc/batchnorm.cu, CUDA
C++ for sm_90a built by ops/_build.py) or raise: 3 launches forward
(train_bn_stats, train_bn_finish, train_bn_norm) and 3 backward
(train_bn_grad_reduce, train_bn_finish, train_bn_grad), which read and
write the activations 8 times in all where the plain version makes ~31
passes. The kernels replace no TPU kernel: the JAX package leaves its BN to
XLA's fusion.

Layouts: the kernels take x with channels innermost (NCHW in channels_last
memory, the networks' activations; NCDHW in channels_last_3d) as an
(N * positions, C) matrix, the "rows" plan, or contiguous (N, C, ...), each
(sample, channel) plane contiguous (the V2V's volumes), the "planes" plan.
`layout_of` picks the plan from the strides; any other layout raises
(`check_launch`). A gradient dy in another layout than x is copied into
x's first (`relayouts` counts those copies).
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from .. import cuda_graphs
from ..parallel.mesh import all_reduce
from ._build import load_library

# the kernels' constants (csrc/batchnorm.cu, which a CPU test holds these
# against): threads a block, bytes of a load, channel vectors a rows block
# spans, loads a thread issues at once, blocks an SM holds, the largest
# grid.y
_THREADS, _VEC_BYTES, _MAX_TILE_VEC, _UNROLL, _BLOCKS_PER_SM = (
    256, 16, 32, 4, 2)
_MAX_GRID_Y = 65535
_SMS = 132                      # streaming multiprocessors of an H100
_TARGET_BLOCKS = _BLOCKS_PER_SM * _SMS   # one wave
_DTYPES = (torch.float32, torch.bfloat16)
_LAYOUTS = {"rows": 0, "planes": 1}


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# ------------------------------------------------------------ plain version

def _bn_axes(x):
    """The reduced dims of an (N, C, ...) tensor, and the view shapes of a
    per-channel and of a per-row vector."""
    lead = (1,) * (x.dim() - 2)
    return ((0,) + tuple(range(2, x.dim())), (1, x.shape[1]) + lead,
            (x.shape[0], 1) + lead)


def plain_forward(x, weight, bias, mask, eps, group):
    """Eager PyTorch: -> (y, mean, var, saved, count), saved = (mean, r,
    var_raw > 0) and count the (global) count of rows x positions, a
    number or a 0-d tensor, for `plain_backward`."""
    B, C = x.shape[:2]
    dims, ch, rows = _bn_axes(x)
    xf = x.float()
    if mask is None:
        count = x.numel() // C
        s1, s2 = xf.sum(dims), (xf * xf).sum(dims)
    else:
        xm = xf * mask.view(rows)
        count = mask.sum() * (x.numel() // (B * C))
        s1, s2 = xm.sum(dims), (xm * xf).sum(dims)
    if group is not None:
        if mask is None:
            # a fill: a CUDA graph of the step captures it
            count = torch.full((), float(count), dtype=torch.float32,
                               device=x.device)
        s1, s2, count = all_reduce(group, [s1, s2, count.reshape(1)],
                                   "bn forward")
        count = count.reshape(())
    mean = s1 / count
    mu2 = s2 / count
    var_raw = mu2 - mean * mean
    var = var_raw.clamp_min(0.0)
    r = torch.rsqrt(var + eps)
    y = ((xf - mean.view(ch)) * (r * weight).view(ch) + bias.view(ch))
    return y.to(x.dtype), mean, var, (mean, r, var_raw > 0), count


def plain_backward(dy, x, weight, mask, saved, count, group):
    """Eager PyTorch: -> (dx, dweight, dbias) from plain_forward's saved
    tensors and count."""
    mean, r, var_pos = saved
    dims, shape, rows = _bn_axes(x)
    xf, dy = x.float(), dy.float()

    def ch(v):
        return v.view(shape)

    s = (dy * (xf - ch(mean))).sum(dims)
    dbias = dy.sum(dims)
    dweight = s * r
    if group is not None:
        # dx takes the whole batch's sums; dweight and dbias the rank's
        dbias_local = dbias
        s, dbias = all_reduce(group, [s, dbias], "bn backward")
    g = weight * r
    # through var = max(mu2 - mean^2, 0) into mean and mu2 = E[x^2]
    dvar = torch.where(var_pos, -0.5 * s * weight * r * r * r, 0.0)
    dmean = -dbias * g - 2.0 * mean * dvar
    stat = ch(dmean / count) + xf * ch(2.0 * dvar / count)
    if mask is not None:
        stat = stat * mask.view(rows)
    direct = dy * ch(g)
    if x.dtype == torch.float32:
        dx = direct + stat
    else:
        dx = direct.to(x.dtype) + stat.to(x.dtype)
    if group is not None:
        dbias = dbias_local
    return dx, dweight, dbias


# ------------------------------------------------------------- launch plan

def _channels_last_strides(shape: Sequence[int]):
    """The strides of a dense tensor of `shape` with dim 1 innermost."""
    order = [0] + list(range(2, len(shape))) + [1]
    strides, step = [0] * len(shape), 1
    for d in reversed(order):
        strides[d] = step
        step *= shape[d]
    return strides


def _dense_as(shape, strides, want) -> bool:
    """strides equal `want` wherever the size is not 1."""
    return all(size == 1 or s == w
               for size, s, w in zip(shape, strides, want))


def _contiguous_strides(shape: Sequence[int]):
    strides, step = [0] * len(shape), 1
    for d in reversed(range(len(shape))):
        strides[d] = step
        step *= shape[d]
    return strides


def layout_of(shape: Sequence[int], strides: Sequence[int]) -> Optional[str]:
    """"rows" for channels innermost, "planes" for contiguous (N, C, ...),
    None for any other layout. A tensor that is both (a size-1 dim) takes
    the rows plan."""
    if _dense_as(shape, strides, _channels_last_strides(shape)):
        return "rows"
    if _dense_as(shape, strides, _contiguous_strides(shape)):
        return "planes"
    return None


@dataclass(frozen=True)
class LaunchPlan:
    """One grid for the four passes of a layer (the finish has its own)."""
    layout: str          # "rows" or "planes"
    vec: int             # elements of one load: 16 bytes, or 1
    tile: int            # rows: channel vectors a block; planes: 1
    lanes: int           # rows: row lanes a block; planes: _THREADS
    span: int            # rows a block (rows) or vectors a block (planes)
    blocks: int          # blocks along the rows or a channel: partial rows
    grid: tuple          # (blocks, channel tiles) or (blocks, C)
    channels: int

    @property
    def partial_floats(self) -> int:
        """The (2, blocks, C) partials' size in floats."""
        return 2 * self.blocks * self.channels


@functools.lru_cache(maxsize=256)
def launch_plan(layout: str, n: int, c: int, s: int, elt: int,
                aligned: bool = True) -> LaunchPlan:
    """The grid of a layer of n samples, c channels and s positions a
    sample and channel, `elt` bytes an element. Loads are 16 bytes where
    the address is `aligned` and C (rows) or s (planes) holds whole
    vectors, else one element. The grid holds at most one wave of
    _BLOCKS_PER_SM blocks an SM where the channel tiles allow, every block
    taking an equal slab, and a thread at least _UNROLL loads."""
    full = _VEC_BYTES // elt
    if layout == "rows":
        vec = full if aligned and c % full == 0 else 1
        cvec = c // vec
        tile = min(cvec, _MAX_TILE_VEC)
        lanes = _THREADS // tile
        tiles = _ceil_div(cvec, tile)
        units = n * s
        want = max(1, min(_TARGET_BLOCKS // tiles,
                          _ceil_div(units, lanes * _UNROLL)))
    elif layout == "planes":
        vec = full if aligned and s % full == 0 else 1
        tile, lanes, tiles = 1, _THREADS, c
        units = n * s // vec
        want = max(1, min(_TARGET_BLOCKS // c,
                          _ceil_div(units, _THREADS * _UNROLL)))
    else:
        raise ValueError(f"train BN: unknown layout {layout!r}")
    span = _ceil_div(units, want)
    blocks = _ceil_div(units, span)
    return LaunchPlan(layout, vec, tile, lanes, span, blocks, (blocks, tiles),
                      c)


_RULES = ("dtype float32 or bfloat16", "(N, C, ...) with at least 3 dims",
          "channels innermost or contiguous (N, C, ...)",
          "fewer than 2**31 elements", f"C <= {_MAX_GRID_Y}")


def check_launch(dtype: torch.dtype, shape: Sequence[int],
                 strides: Sequence[int]) -> None:
    """What the kernels take as x (a CPU tensor takes the plain version,
    whatever its layout): fp32 or bf16, 3 dims or more, one of the two
    layouts, an int32 element count, C within a grid dimension. Raises
    ValueError naming the rules and the ones broken."""
    ok = [dtype in _DTYPES, len(shape) >= 3,
          layout_of(shape, strides) is not None, math.prod(shape) < 2 ** 31,
          len(shape) >= 2 and shape[1] <= _MAX_GRID_Y]
    if not all(ok):
        broken = [r for r, good in zip(_RULES, ok) if not good]
        raise ValueError(
            f"train BN: a CUDA x must have {', '.join(_RULES)}; got {dtype} "
            f"shape {tuple(shape)} strides {tuple(strides)}; broken: "
            f"{', '.join(broken)}")


# ------------------------------------------------------------------ kernels

@functools.lru_cache(maxsize=None)
def _entries():
    lib = load_library("batchnorm")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    plan = [I] * 6               # layout, vec, tile, lanes, span, blocks
    args = {
        "train_bn_stats_launch": [P, I, P, I, I, I, *plan, P, P],
        "train_bn_finish_launch": [P, I, I, P, I, I, P, P, P, P, P],
        "train_bn_norm_launch": [P, I, P, P, P, F, I, I, I, *plan,
                                 P, P, P, P, P, P],
        "train_bn_grad_reduce_launch": [P, P, I, P, I, I, I, *plan, P, P],
        "train_bn_grad_launch": [P, P, I, P, P, P, P, P, P, P, I, I, I,
                                 *plan, P, P],
    }
    out = {}
    for name, argtypes in args.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        out[name] = fn
    return out


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _call(name, *args):
    err = _entries()[name](*args)
    if err:
        raise RuntimeError(f"train BN: {name}: CUDA error {err} at launch")


def _geometry(x):
    n, c = x.shape[:2]
    return n, c, x.numel() // (n * c)


def _plan_of(x, *others) -> LaunchPlan:
    n, c, s = _geometry(x)
    aligned = all(t.data_ptr() % _VEC_BYTES == 0 for t in (x,) + others)
    return launch_plan(layout_of(x.shape, x.stride()), n, c, s,
                       x.element_size(), aligned)


def _plan_args(plan: LaunchPlan):
    return (_LAYOUTS[plan.layout], plan.vec, plan.tile, plan.lanes,
            plan.span, plan.blocks)


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check_cuda(x, weight, bias, mask):
    check_launch(x.dtype, tuple(x.shape), x.stride())
    c = x.shape[1]
    for name, t in (("weight", weight), ("bias", bias)):
        if (t is None or t.dtype != torch.float32 or t.device != x.device
                or tuple(t.shape) != (c,) or not t.is_contiguous()):
            raise ValueError(f"train BN: {name} must be a contiguous ({c},) "
                             f"float32 tensor on {x.device}")
    if mask is not None and (
            mask.dtype != torch.float32 or mask.device != x.device
            or tuple(mask.shape) != (x.shape[0],)
            or not mask.is_contiguous()):
        raise ValueError(f"train BN: mask must be a contiguous "
                         f"({x.shape[0]},) float32 tensor on {x.device}")


def train_bn_forward(x, weight, bias, mask, eps, group):
    """(N, C, ...) x -> (y, mean, var, saved, count): y in x.dtype and
    x's layout, the batch mean and biased variance (fp32, (C,)), the
    tensors `train_bn_backward` takes and the count of rows x positions.

    On a CPU tensor: `plain_forward`. On a CUDA tensor: train_bn_stats and
    train_bn_finish, the packed all_reduce under `group`, train_bn_norm;
    or it raises. `train_bn_forward.launches` counts the kernel launches.
    """
    if x.device.type == "cpu":
        return plain_forward(x, weight, bias, mask, eps, group)
    _check_cuda(x, weight, bias, mask)
    n, c, s = _geometry(x)
    y = torch.empty_like(x)
    plan = _plan_of(x, y)
    dev, f32 = x.device, torch.float32
    part = torch.empty(plan.partial_floats, dtype=f32, device=dev)
    packed = torch.empty(2 * c + 1, dtype=f32, device=dev)
    st = _stream(dev)
    bf16 = int(x.dtype == torch.bfloat16)
    _call("train_bn_stats_launch", _ptr(x), bf16, _ptr(mask), n, c, s,
          *_plan_args(plan), _ptr(part), st)
    _call("train_bn_finish_launch", _ptr(part), plan.blocks, c, _ptr(mask),
          n, s, None, _ptr(packed), None, None, st)
    if group is not None:
        packed, = all_reduce(group, [packed], "bn forward")
    mean, var, r = (torch.empty(c, dtype=f32, device=dev) for _ in range(3))
    pos = torch.empty(c, dtype=torch.bool, device=dev)
    _call("train_bn_norm_launch", _ptr(x), bf16, _ptr(packed), _ptr(weight),
          _ptr(bias), float(eps), n, c, s, *_plan_args(plan), _ptr(y),
          _ptr(mean), _ptr(var), _ptr(r), _ptr(pos), st)
    train_bn_forward.launches += 3
    return y, mean, var, (mean, r, pos), packed[2 * c]


def train_bn_backward(dy, x, weight, mask, saved, count, group):
    """The gradient of train_bn_forward: -> (dx, dweight, dbias), dx in
    x.dtype and x's layout, dweight and dbias fp32 (C,), the rank's share.

    On a CPU tensor: `plain_backward`. On a CUDA tensor: train_bn_grad_
    reduce and train_bn_finish, the packed all_reduce under `group`,
    train_bn_grad; or it raises. `train_bn_backward.launches` counts the
    kernel launches.
    """
    if x.device.type == "cpu":
        return plain_backward(dy, x, weight, mask, saved, count, group)
    mean, r, pos = saved
    if dy.dtype != x.dtype or dy.shape != x.shape:
        raise ValueError(f"train BN: the gradient must be {x.dtype} of shape "
                         f"{tuple(x.shape)}, got {dy.dtype} "
                         f"{tuple(dy.shape)}")
    if dy.stride() != x.stride() or dy.data_ptr() % _VEC_BYTES:
        dy = torch.empty_like(x).copy_(dy)
        train_bn_backward.relayouts += 1
    n, c, s = _geometry(x)
    dx = torch.empty_like(x)
    plan = _plan_of(x, dy, dx)
    dev, f32 = x.device, torch.float32
    part = torch.empty(plan.partial_floats, dtype=f32, device=dev)
    packed = torch.empty(2 * c, dtype=f32, device=dev)
    dweight = torch.empty(c, dtype=f32, device=dev)
    dbias = torch.empty(c, dtype=f32, device=dev)
    st = _stream(dev)
    bf16 = int(x.dtype == torch.bfloat16)
    _call("train_bn_grad_reduce_launch", _ptr(dy), _ptr(x), bf16, _ptr(mean),
          n, c, s, *_plan_args(plan), _ptr(part), st)
    _call("train_bn_finish_launch", _ptr(part), plan.blocks, c, None, n, s,
          _ptr(r), _ptr(packed), _ptr(dweight), _ptr(dbias), st)
    if group is not None:
        packed, = all_reduce(group, [packed], "bn backward")
    _call("train_bn_grad_launch", _ptr(dy), _ptr(x), bf16, _ptr(mask),
          _ptr(packed), _ptr(count), _ptr(weight), _ptr(mean), _ptr(r),
          _ptr(pos), n, c, s, *_plan_args(plan), _ptr(dx), st)
    train_bn_backward.launches += 3
    return dx, dweight, dbias


cuda_graphs.carry("train_bn_forward", train_bn_forward)
cuda_graphs.carry("train_bn_backward", train_bn_backward)
train_bn_backward.relayouts = 0
