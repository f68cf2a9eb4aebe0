"""Int8 quantization primitives of the serving path. Port of
fast3dhpe_tpu/ops/quant.py.

Scheme (as the JAX package's):
- weights: per-output-channel symmetric int8, BN folded in first, an
  all-zero channel at scale 1;
- activations: per-tensor symmetric int8, scale calibrated offline
  (max-abs over calibration batches, or an upper quantile);
- accumulation: int32, exact, so a convolution equals the JAX package's
  bit for bit; dequant, bias, ReLU and requant are separate elementwise
  passes here (ROADMAP B queues a kernel that runs them in its epilogue).

Layouts. Activations are NHWC int8 tensors, as in JAX. The port's weights
are OIHW (transposed convs (I, O, kh, kw)); a pack keeps JAX's HWIO
(transposed (kh, kw, O, I)) so that either package loads the other's.
`gemm_weight` / `gemm_weight_transposed` turn a packed kernel once, when a
pack is prepared (models/quantized.py), into the (N, K) int8 matrix that
`conv_i8` multiplies.

The convolution is an im2col through `Tensor.unfold` views (any dtype)
and one `torch._int_mm` (int8 x int8 -> int32; cuBLASLt on CUDA). There
is no hand-written kernel on this path: the JAX package runs the same
product through XLA, outside Pallas. `torch._int_mm` on CUDA takes
(M, K) @ (K, N) with M > 16 and K, N positive multiples of 8 (its
checks: "self.size(0) needs to be greater than 16", "self.size(1) needs
to be greater than 0 and a multiple of 8", "mat2.size(1) needs to be
greater than 0 and a multiple of 8"); `gemm_weight` pads K and N with
zero rows and columns and `conv_i8` pads M, all of which is exact: the
stem's K = 7*7*3 = 147 becomes 152, final_layer's N = 19 joints 24. The
same call runs on the CPU, which has no such limits, so the CPU tests
cover the padding.

A transposed convolution (k 4, stride 2, padding 1) is a zero insertion
(stride 2) and a padding of k - 1 - p = 2 on each side, then `conv_i8`
with the kernel flipped and its channels swapped. Its patches are four
times the input's im2col: at 64 images of 256 px, deconv1's are 0.54 GB
and deconv3's 1.07 GB of int8, the stem's 0.16 GB (PERF.md).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

INT8_MAX = 127.0
_MIN_ROWS = 17        # torch._int_mm on CUDA: more than 16 rows
_ALIGN = 8            # and K, N multiples of 8


def fold_bn(kernel, scale, bias, mean, var, eps: float = 1e-5,
            out_axis: int = 0):
    """Fold inference-mode BatchNorm into the preceding conv:
    g = scale / sqrt(var + eps) per output channel, kernel * g and
    bias - mean * g, both fp32 (quant.py:30-47). out_axis indexes the
    kernel's output channels: 0 for OIHW, 1 for a transposed conv's
    (I, O, kh, kw)."""
    g = (scale / torch.sqrt(var + eps)).float()
    shape = [1] * kernel.dim()
    shape[out_axis] = -1
    return kernel.float() * g.reshape(shape), (bias - mean * g).float()


def quantize_kernel(kernel, out_axis: int = 0):
    """Per-output-channel symmetric int8 (quant.py:50-65): (q int8, scale
    (K,) fp32); an all-zero channel gets scale 1 (its q is all zero)."""
    kernel = kernel.float()
    axes = tuple(i for i in range(kernel.dim())
                 if i != out_axis % kernel.dim())
    amax = kernel.abs().amax(dim=axes)
    s = torch.where(amax > 0, amax / INT8_MAX,
                    torch.ones_like(amax)).float()
    shape = [1] * kernel.dim()
    shape[out_axis] = -1
    q = torch.clamp(torch.round(kernel / s.reshape(shape)), -INT8_MAX,
                    INT8_MAX).to(torch.int8)
    return q, s


def requant(y_fp, s_out):
    """fp -> int8 at the per-tensor scale s_out: round half to even of
    y / s_out (a division, as JAX has it), clipped to +-127."""
    return torch.clamp(torch.round(y_fp / s_out), -INT8_MAX,
                       INT8_MAX).to(torch.int8)


def dequant(x8, s):
    return x8.float() * s


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def _pad_matrix(w):
    """(N, K) -> zero-padded to multiples of 8 in both dimensions."""
    n, k = w.shape
    return F.pad(w, (0, _round_up(k, _ALIGN) - k, 0,
                     _round_up(n, _ALIGN) - n)).contiguous()


def gemm_weight(w_hwio):
    """A packed HWIO int8 conv kernel (kh, kw, Cin, Cout) -> the (N, K)
    matrix conv_i8 multiplies, rows the output channels (N = Cout rounded
    up to 8), columns in im2col order (Cin, kh, kw), K rounded up to 8."""
    cout = w_hwio.shape[3]
    return _pad_matrix(w_hwio.permute(3, 2, 0, 1).reshape(cout, -1))


def gemm_weight_transposed(w_khkwoi):
    """A packed transposed-conv kernel (kh, kw, O, I) -> the matrix of the
    equivalent stride-1 conv over the zero-inserted input: the kernel
    flipped in both spatial axes, O rows, (I, kh, kw) columns."""
    w = w_khkwoi.flip(0, 1).permute(2, 3, 0, 1)        # (O, I, kh, kw)
    return _pad_matrix(w.reshape(w.shape[0], -1))


def _im2col(x8, k: int, stride: int, pad: int):
    """(N, H, W, C) -> ((N * Ho * Wo, C * k * k) patches, (N, Ho, Wo))."""
    if pad:
        x8 = F.pad(x8, (0, 0, pad, pad, pad, pad))
    n = x8.shape[0]
    if k == 1:
        p = x8[:, ::stride, ::stride]
        return p.reshape(-1, p.shape[-1]), p.shape[:3]
    p = x8.unfold(1, k, stride).unfold(2, k, stride)   # (N, Ho, Wo, C, k, k)
    return p.reshape(n * p.shape[1] * p.shape[2], -1), p.shape[:3]


def conv_i8(x8, w_gemm, cout: int, k: int, stride: int = 1, pad: int = 0):
    """int8 x int8 -> int32 NHWC convolution with torch-style symmetric
    zero padding (quant.py:78-84), exact.

    x8: (N, H, W, Cin) int8; w_gemm: the (N', K') matrix of gemm_weight
    for a k x k kernel with `cout` output channels. Returns (N, Ho, Wo,
    cout) int32.
    """
    a, (n, ho, wo) = _im2col(x8, k, stride, pad)
    m, kk = a.shape
    kp = w_gemm.shape[1]
    if kk != kp or m < _MIN_ROWS:
        a = F.pad(a, (0, kp - kk, 0, max(0, _MIN_ROWS - m)))
    acc = torch._int_mm(a.contiguous(), w_gemm.t())
    return acc[:m, :cout].reshape(n, ho, wo, cout)


def conv_transpose_i8(x8, w_gemm, cout: int, k: int = 4, stride: int = 2,
                      pad: int = 1):
    """int8 ConvTranspose2d(k, stride, pad) with torch semantics
    (quant.py:87-98), exact: zero insertion, padding k - 1 - pad, and the
    flipped kernel's matrix (gemm_weight_transposed)."""
    n, h, w, c = x8.shape
    z = x8.new_zeros((n, (h - 1) * stride + 1, (w - 1) * stride + 1, c))
    z[:, ::stride, ::stride] = x8
    return conv_i8(z, w_gemm, cout, k, 1, k - 1 - pad)


def max_pool_i8(x8, window: int = 3, stride: int = 2, padding: int = 1):
    """MaxPool2d on NHWC int8 (quant.py:101-107): padded with -128, which
    never beats a real cell, then the max of each window over unfold
    views, in int8 on either device."""
    xp = F.pad(x8, (0, 0, padding, padding, padding, padding), value=-128)
    return xp.unfold(1, window, stride).unfold(2, window, stride).amax(
        dim=(-2, -1))


def abs_stat(t, percentile=None):
    """Calibration statistic of |t| (quant.py:110-116): the max, or for a
    percentile in (0, 100) jnp.quantile's linear interpolation between
    two order statistics, its position q * (n - 1) computed in fp32 as
    JAX computes it. torch.quantile refuses more than 2^24 elements, so
    the order statistics come from kthvalue."""
    a = t.float().abs()
    if percentile is None or percentile >= 100:
        return a.max()
    flat = a.reshape(-1)
    n = flat.numel()
    q = (torch.tensor(percentile / 100.0, dtype=torch.float32)
         * (torch.tensor(float(n), dtype=torch.float32) - 1.0))
    low, high = torch.floor(q), torch.ceil(q)
    w_high = q - low
    w_low = 1.0 - w_high
    lo = torch.kthvalue(flat, int(low.clamp(0, n - 1)) + 1).values
    hi = torch.kthvalue(flat, int(high.clamp(0, n - 1)) + 1).values
    return lo * w_low.to(a.device) + hi * w_high.to(a.device)
