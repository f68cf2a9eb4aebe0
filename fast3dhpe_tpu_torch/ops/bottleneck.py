"""Fused eval-mode ResNet Bottleneck: wrapper, plain version, BN folding.

Port of fast3dhpe_tpu/ops/pallas_bottleneck.py. The kernel is
csrc/fused_bottleneck.cu (CUDA C++ for sm_90a, built by ops/_build.py); it
replaces `_bottleneck_kernel` (pallas_call at pallas_bottleneck.py:191).
The TPU kernel's `conv2_mode` and `samples_per_cell` choose between VMEM
layouts of the same function, so the port has neither.

Weights keep the JAX package's layouts: w1 (Cin, P), w2 (3, 3, P, P) HWIO,
w3 (P, 4P), wd (Cin, 4P). Activations are NCHW tensors in channels_last
memory, i.e. NHWC bytes, as the kernel reads them.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._build import load_library

_SMEM_LIMIT = 232448          # bytes of shared memory one H100 block may use


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


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


@functools.lru_cache(maxsize=None)
def _entry():
    fn = load_library("fused_bottleneck").fused_bottleneck_bf16
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_bottleneck(x, w1, s1, b1, w2, s2, b2, w3, s3, b3,
                     wd=None, sd=None, bd=None):
    """One stride-1 eval-mode Bottleneck as one kernel launch.

    x: (B, Cin, H, W), channels_last. On a CPU tensor this runs
    `bottleneck_plain`; on a CUDA tensor it launches
    csrc/fused_bottleneck.cu (bf16 only) or raises.
    Returns (B, 4P, H, W) in x.dtype, channels_last.
    """
    if x.device.type == "cpu":
        return bottleneck_plain(x, w1, s1, b1, w2, s2, b2, w3, s3, b3,
                                wd, sd, bd)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bottleneck: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused_bottleneck: the kernel takes bf16, "
                        f"got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("fused_bottleneck: x must be a 4-d channels_last "
                         "tensor")
    B, Cin, H, W = x.shape
    P = w1.shape[1]
    Cout = w3.shape[1]
    if (w1.shape != (Cin, P) or w2.shape != (3, 3, P, P)
            or w3.shape != (P, Cout)):
        raise ValueError(f"fused_bottleneck: weight shapes {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)}, {tuple(w3.shape)} do not fit "
                         f"Cin={Cin}")
    if wd is None and Cin != Cout:
        raise ValueError("fused_bottleneck: identity residual needs "
                         "Cin == 4P")
    if wd is not None and wd.shape != (Cin, Cout):
        raise ValueError(f"fused_bottleneck: wd shape {tuple(wd.shape)}")
    if Cin % 8 or P % 32 or Cout % 128:
        raise ValueError(f"fused_bottleneck: the kernel needs Cin % 8 == 0, "
                         f"P % 32 == 0 and Cout % 128 == 0, got Cin={Cin} "
                         f"P={P} Cout={Cout}")
    smem = 2 * (100 * Cin + 164 * P)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"fused_bottleneck: {smem} bytes of shared memory "
                         f"exceed the {_SMEM_LIMIT} a block may use")

    dev = x.device

    def w(t):
        return t.to(device=dev, dtype=torch.bfloat16).contiguous()

    def v(t):
        return t.to(device=dev, dtype=torch.float32).contiguous()

    args = [w(w1), v(s1), v(b1), w(w2.reshape(9 * P, P)), v(s2), v(b2),
            w(w3), v(s3), v(b3)]
    if wd is not None:
        args += [w(wd), v(sd), v(bd)]
    out = torch.empty((B, Cout, H, W), dtype=torch.bfloat16, device=dev,
                      memory_format=torch.channels_last)
    ptrs = [_ptr(a) for a in args]
    if wd is None:
        ptrs += [None, None, None]
    err = _entry()(_ptr(x), *ptrs, _ptr(out), B, H, W, Cin, P, Cout,
                   ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err:
        raise RuntimeError(f"fused_bottleneck: CUDA error {err} at launch")
    fused_bottleneck.launches += 1
    return out


fused_bottleneck.launches = 0
