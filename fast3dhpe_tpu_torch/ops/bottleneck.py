"""Fused eval-mode ResNet Bottleneck: wrapper, plain version, BN folding,
weight packing.

Port of fast3dhpe_tpu/ops/pallas_bottleneck.py. The kernel is
csrc/fused_bottleneck.cu (CUDA C++ for sm_90a, built by ops/_build.py); it
replaces `_bottleneck_kernel` (pallas_call at pallas_bottleneck.py:191).
The TPU kernel's `conv2_mode` and `samples_per_cell` choose between VMEM
layouts of the same function, so the port has neither.

Weights come in the JAX package's layouts: w1 (Cin, P), w2 (3, 3, P, P)
HWIO, w3 (P, 4P), wd (Cin, 4P). The kernel reads them packed into one bf16
buffer, each transposed to K-major (N, K) as wgmma's B operand, and the
folded BNs into one fp32 buffer (`pack_weights`, index map
`weight_layout`; `PackedBottleneck.unpack` reads the JAX layouts back as
views); `models/resnet.py` packs once per weight version.
Activations are NCHW tensors in channels_last memory, i.e. NHWC bytes, as
the kernel reads them.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .. import cuda_graphs
from ._build import load_library

_SMEM_LIMIT = 232448          # bytes of shared memory one H100 block may use
# the kernel's tiling (the constants of csrc/fused_bottleneck.cu, which a
# CPU test holds these against): 8x16 output tiles (8x8 for small
# launches) in clusters of 2 that share one weight stream; K in chunks of
# 64 (one 128-byte swizzled row), through a ring of 3 x chunks of 192 halo
# rows and a ring of 4 weight chunks; the residual and conv3 in passes of
# 128 channels; regions aligned to the swizzle's 1024-byte period
_TH, _TW_BIG, _TW_SMALL, _KC, _N3 = 8, 16, 8, 64, 128
_CLUSTER, _X_STAGES, _W_STAGES, _ALIGN = 2, 3, 4, 1024
_HALO_BIG = (_TH + 2) * (_TW_BIG + 2)                # 180
_TILE_PIX_BIG = _TH * _TW_BIG                        # 128
_X_STAGE = (_HALO_BIG + 63) // 64 * 64 * _KC * 2     # 192 rows of 128 bytes
_OUT_TILE = _TILE_PIX_BIG * _N3 * 2
_SMS = 132                    # H100 SXM
_SMALL_CTAS = _SMS // 2       # an 8x16 launch this small takes 8x8 tiles
_CLUSTERS = _SMS // 2         # resident clusters of 2, one CTA an SM
# TMA's own limits follow from these rules: Cin % 64 and Cout % 128 give
# 16-byte global strides, and P <= 128 keeps every box within 256 rows
# (a weight box is P / 2 or 64 rows, an x box at most 18 pixels)
_RULES = ("Cin % 64 == 0", "P == 64 or P == 128", "Cout % 128 == 0",
          "Cin == Cout without a downsample", "1 <= B <= 65535",
          f"shared memory <= {_SMEM_LIMIT} bytes")


def fold_bn(scale, bias, mean, var, eps: float = 1e-5):
    """BatchNorm with running statistics -> per-channel (s, b), fp32:
    y = x * s + b. Mirrors pallas_bottleneck.fold_bn."""
    s = scale / torch.sqrt(var + eps)
    return s.float(), (bias - mean * s).float()


def _conv(h, w_oihw, pad):
    return F.conv2d(h.float(), w_oihw.float(), padding=pad)


def _chan(v):
    return v.float().reshape(1, -1, 1, 1)


def bottleneck_plain(x, w1, s1, b1, w2, s2, b2, w3, s3, b3,
                     wd=None, sd=None, bd=None):
    """The kernel's function in plain PyTorch, at the kernel's rounding
    points: every conv sums in fp32 over inputs in x.dtype; h1, h2, h3 and
    the downsampled residual round to x.dtype; the residual add is in
    x.dtype (pallas_bottleneck.py:111-126).

    x: (B, Cin, H, W). Returns (B, 4P, H, W) in x.dtype.
    """
    dt = x.dtype
    w1c = w1.to(dt).t()[:, :, None, None]
    w2c = w2.to(dt).permute(3, 2, 0, 1)
    w3c = w3.to(dt).t()[:, :, None, None]
    h = torch.relu(_conv(x, w1c, 0) * _chan(s1) + _chan(b1)).to(dt)
    h = torch.relu(_conv(h, w2c, 1) * _chan(s2) + _chan(b2)).to(dt)
    h3 = (_conv(h, w3c, 0) * _chan(s3) + _chan(b3)).to(dt)
    if wd is not None:
        wdc = wd.to(dt).t()[:, :, None, None]
        r = (_conv(x, wdc, 0) * _chan(sd) + _chan(bd)).to(dt)
    else:
        r = x
    return torch.relu(h3 + r)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _ceil_div(a, b) * b


def smem_bytes(planes: int, downsample: bool) -> int:
    """Dynamic shared memory of one launch (the kernel's `smem_bytes`), the
    same for both tiles and with or without a downsample: h1 (or, once it
    is dead, the output tile), h2, the ring of x chunks, the ring of weight
    chunks, one 1024-byte block of mbarriers and one for aligning the
    base."""
    region1 = _round_up(max(_HALO_BIG * planes * 2, _OUT_TILE), _ALIGN)
    w_stage = max(planes, _N3) * _KC * 2
    return (_ALIGN + region1 + _TILE_PIX_BIG * planes * 2
            + _X_STAGES * _X_STAGE + _W_STAGES * w_stage + _ALIGN)


@dataclass(frozen=True)
class LaunchPlan:
    """One K3 launch (the kernel's `plan_of`). Each image's plane is cut
    into `tile`s of output pixels (rows, columns), numbered row-major and
    padded to whole clusters with tiles that lie past the image; the work
    is `items` pairs of neighbouring tiles over the images, in order. The
    launch has `ctas` CTAs in clusters of `cluster`, at most one cluster
    for every two SMs: cluster c takes items c, c + ctas / cluster, ...,
    and its CTA of rank r the item's tile r."""
    ctas: int
    cluster: int
    items: int
    tile: Tuple[int, int]
    variant: str          # "8x16", or "8x8" for launches that are small


def launch_plan(batch: int, height: int, width: int) -> LaunchPlan:
    """The kernel's launch for `batch` images of height x width: 8x16
    tiles, unless those would make at most half as many CTAs as the H100
    has SMs; then 8x8 tiles, twice the CTAs. The channels do not enter."""
    def tiles(tw):
        return _round_up(_ceil_div(height, _TH) * _ceil_div(width, tw),
                         _CLUSTER)
    tw = _TW_SMALL if tiles(_TW_BIG) * batch <= _SMALL_CTAS else _TW_BIG
    items = tiles(tw) // _CLUSTER * batch
    return LaunchPlan(_CLUSTER * min(items, _CLUSTERS), _CLUSTER, items,
                      (_TH, tw), f"{_TH}x{tw}")


def check_launch(batch: int, cin: int, planes: int, cout: int,
                 downsample: bool) -> int:
    """The kernel's rules on a block's sizes. Returns the launch's dynamic
    shared memory in bytes; raises ValueError naming every rule and the
    ones broken. Narrower than the earlier mma.sync kernel's (Cin % 32,
    P % 128) only where no gate reaches: `Bottleneck.fusable` admits
    stride-1 blocks of P = 64 (Cin 64 or 256) and P = 128 (Cin 512); at
    P = 256 (Cin 1024) its VMEM estimate is 13 MiB or more for every plane
    of 1024 pixels or more, so no P = 256 block fuses."""
    smem = smem_bytes(planes, downsample)
    ok = (cin % _KC == 0, planes in (64, 128), cout % _N3 == 0,
          downsample or cin == cout, 1 <= batch <= 65535,
          smem <= _SMEM_LIMIT)
    if not all(ok):
        broken = [r for r, good in zip(_RULES, ok) if not good]
        raise ValueError(
            f"fused_bottleneck: the kernel needs {', '.join(_RULES)}; got "
            f"B={batch} Cin={cin} P={planes} Cout={cout} "
            f"downsample={downsample}, {smem} bytes of shared memory; "
            f"broken: {', '.join(broken)}")
    return smem


# how each weight is stored: its JAX layout permuted to K-major (N, K)
_STORED = {"w1": (1, 0), "w2": (3, 0, 1, 2), "w3": (1, 0), "wd": (1, 0)}


def weight_layout(cin: int, planes: int, cout: int, downsample: bool
                  ) -> Tuple[Dict[str, Tuple[int, tuple]],
                             Dict[str, Tuple[int, int]]]:
    """The packed buffers' index map: name -> (offset, JAX shape) in the
    bf16 weight buffer, and name -> (offset, length) in the fp32 buffer of
    folded BNs. Each weight is stored K-major, its JAX layout permuted by
    `_STORED`: w1 as (P, Cin), w2 (3, 3, P, P) HWIO as (P, 3, 3, P), i.e.
    the kernel's (P, 9 P) with columns (ky, kx, cin), w3 as (Cout, P), wd
    as (Cout, Cin)."""
    shapes = {"w1": (cin, planes), "w2": (3, 3, planes, planes),
              "w3": (planes, cout)}
    lengths = {"s1": planes, "b1": planes, "s2": planes, "b2": planes,
               "s3": cout, "b3": cout}
    if downsample:
        shapes["wd"] = (cin, cout)
        lengths.update(sd=cout, bd=cout)
    weights, vectors, off = {}, {}, 0
    for name, shape in shapes.items():
        weights[name] = (off, shape)
        off += int(torch.Size(shape).numel())
    off = 0
    for name, n in lengths.items():
        vectors[name] = (off, n)
        off += n
    return weights, vectors


def _inverse(perm):
    return tuple(perm.index(i) for i in range(len(perm)))


@dataclass(frozen=True)
class PackedBottleneck:
    """A block's weights as the kernel reads them: `w` bf16 and `sb` fp32,
    laid out by `weight_layout`."""
    w: torch.Tensor
    sb: torch.Tensor
    cin: int
    planes: int
    cout: int
    downsample: bool

    def unpack(self) -> Dict[str, torch.Tensor]:
        """Views of every weight (JAX layout) and folded-BN vector, read
        back through the index map."""
        weights, vectors = weight_layout(self.cin, self.planes, self.cout,
                                         self.downsample)
        out = {}
        for name, (off, shape) in weights.items():
            stored = tuple(shape[i] for i in _STORED[name])
            out[name] = self.w[off:off + torch.Size(shape).numel()].view(
                stored).permute(_inverse(_STORED[name]))
        out.update({name: self.sb[off:off + n]
                    for name, (off, n) in vectors.items()})
        return out

    def args(self):
        """(w1, s1, b1, w2, s2, b2, w3, s3, b3, wd, sd, bd), as
        `bottleneck_plain` takes them."""
        u = self.unpack()
        return tuple(u.get(k) for k in ("w1", "s1", "b1", "w2", "s2", "b2",
                                        "w3", "s3", "b3", "wd", "sd", "bd"))


def pack_weights(w1, s1, b1, w2, s2, b2, w3, s3, b3, wd=None, sd=None,
                 bd=None, device=None) -> PackedBottleneck:
    """Pack a block's weights (JAX layouts) and folded BNs for the kernel,
    on `device` (default: w1's)."""
    device = w1.device if device is None else device
    cin, planes = w1.shape
    cout = w3.shape[1]
    ws = {"w1": w1, "w2": w2, "w3": w3}
    if wd is not None:
        ws["wd"] = wd
    vs = [s1, b1, s2, b2, s3, b3] + ([sd, bd] if wd is not None else [])
    w = torch.cat([t.detach().to(device, torch.bfloat16)
                   .permute(_STORED[name]).reshape(-1)
                   for name, t in ws.items()])
    sb = torch.cat([t.detach().to(device, torch.float32).reshape(-1)
                    for t in vs])
    return PackedBottleneck(w, sb, int(cin), int(planes), int(cout),
                            wd is not None)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


@functools.lru_cache(maxsize=None)
def _entry():
    fn = load_library("fused_bottleneck").fused_bottleneck_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# K3 as a registered operator, so that torch.export traces it (its fake
# tensors have no data_ptr): the CPU implementation is the plain version,
# the CUDA one the kernel, which raises on what it does not take.

@torch.library.custom_op("fast3dhpe::fused_bottleneck", mutates_args=(),
                         device_types="cpu")
def _k3_op(x: torch.Tensor, w: torch.Tensor, sb: torch.Tensor, cin: int,
           planes: int, cout: int, downsample: bool) -> torch.Tensor:
    packed = PackedBottleneck(w, sb, cin, planes, cout, downsample)
    return bottleneck_plain(x, *packed.args()).contiguous(
        memory_format=torch.channels_last)


@_k3_op.register_kernel("cuda")
def _k3_cuda(x, w, sb, cin, planes, cout, downsample):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused_bottleneck: the kernel takes bf16, "
                        f"got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("fused_bottleneck: x must be a 4-d channels_last "
                         "tensor")
    B, Cin, H, W = x.shape
    if Cin != cin:
        raise ValueError(f"fused_bottleneck: x has {Cin} channels, the "
                         f"weights take {cin}")
    if w.device != x.device or sb.device != x.device:
        raise ValueError(f"fused_bottleneck: weights on {w.device}, "
                         f"x on {x.device}")
    check_launch(B, Cin, planes, cout, downsample)
    if x.data_ptr() % 16:
        raise ValueError("fused_bottleneck: x must be 16-byte aligned")
    out = torch.empty((B, cout, H, W), dtype=torch.bfloat16,
                      device=x.device, memory_format=torch.channels_last)
    err = _entry()(_ptr(x), _ptr(w), _ptr(sb), _ptr(out), B, H, W, Cin,
                   planes, cout, int(downsample), ctypes.c_void_p(
                       torch.cuda.current_stream(x.device).cuda_stream))
    if err:
        raise RuntimeError(f"fused_bottleneck: CUDA error {err} at launch")
    fused_bottleneck.launches += 1
    return out


@_k3_op.register_fake
def _k3_fake(x, w, sb, cin, planes, cout, downsample):
    B, _, H, W = x.shape
    return torch.empty((B, cout, H, W), dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last)


def fused_bottleneck_packed(x, packed: PackedBottleneck):
    """One stride-1 eval-mode Bottleneck as one kernel launch, with the
    weights packed by `pack_weights`, through the registered operator
    fast3dhpe::fused_bottleneck.

    x: (B, Cin, H, W), channels_last. On a CPU tensor this runs
    `bottleneck_plain` on the packed weights; on a CUDA tensor it launches
    csrc/fused_bottleneck.cu (bf16 only) or raises.
    Returns (B, Cout, H, W) in x.dtype, channels_last.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_bottleneck: unsupported device {x.device}")
    return _k3_op(x, packed.w, packed.sb, packed.cin, packed.planes,
                  packed.cout, packed.downsample)


def fused_bottleneck(x, w1, s1, b1, w2, s2, b2, w3, s3, b3,
                     wd=None, sd=None, bd=None):
    """One stride-1 eval-mode Bottleneck as one kernel launch, from the
    weights in the JAX layouts, packed on every call: a helper for one-off
    calls. The model packs once and calls `fused_bottleneck_packed`
    (models/resnet.py).

    x: (B, Cin, H, W), channels_last. On a CPU tensor this runs
    `bottleneck_plain`; on a CUDA tensor it launches
    csrc/fused_bottleneck.cu (bf16 only) or raises.
    Returns (B, 4P, H, W) in x.dtype, channels_last.
    `fused_bottleneck.launches` counts the kernel's launches.
    """
    if x.device.type == "cpu":
        return bottleneck_plain(x, w1, s1, b1, w2, s2, b2, w3, s3, b3,
                                wd, sd, bd)
    Cin = x.shape[1]
    P = w1.shape[1]
    Cout = w3.shape[1]
    if (w1.shape != (Cin, P) or w2.shape != (3, 3, P, P)
            or w3.shape != (P, Cout)):
        raise ValueError(f"fused_bottleneck: weight shapes {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)}, {tuple(w3.shape)} do not fit "
                         f"Cin={Cin}")
    if wd is not None and wd.shape != (Cin, Cout):
        raise ValueError(f"fused_bottleneck: wd shape {tuple(wd.shape)}")
    return fused_bottleneck_packed(
        x, pack_weights(w1, s1, b1, w2, s2, b2, w3, s3, b3, wd, sd, bd,
                        device=x.device))


cuda_graphs.carry("fused_bottleneck", fused_bottleneck)
