"""Layer primitives. Port of fast3dhpe_tpu/models/layers.py.

Parameters are fp32. Each layer computes in the dtype of its input, casting
its weights to it explicitly, so a bf16 network rounds where flax's
`dtype=bf16` layers round: a conv rounds its output to bf16 and then adds
its bias in bf16; BN, in eval and in train mode, computes in fp32 from the
bf16 input and rounds once. (Autocast would keep BN in fp32 and round
elsewhere.)

Activations are NCHW tensors in channels_last memory, so cuDNN runs NHWC.

Train mode follows the module's `.training` flag; the BN row mask (padded
loader rows) is passed explicitly to every BatchNorm2d.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """Conv2d with symmetric integer padding, computing in x.dtype."""

    def forward(self, x):
        y = F.conv2d(x, self.weight.to(x.dtype), None, self.stride,
                     self.padding)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype).reshape(1, -1, 1, 1)
        return y


def bn_row_mask(row_valid):
    """(B,) 0/1 row validity -> the (B,) fp32 BN mask (layers.py:47-64).

    Padded loader rows stay out of train-mode batch statistics. An
    all-invalid mask falls back to the whole batch instead of empty-set NaN
    statistics. No host sync: the fallback is a tensor op.
    """
    if row_valid is None:
        return None
    m = torch.as_tensor(row_valid) > 0
    return (m | ~m.any()).float()


class _MaskedBatchNorm(torch.autograd.Function):
    """Train-mode BN over NCHW with batch statistics from the masked rows,
    as flax's BatchNorm computes them with `mask=` (flax 0.12.3
    `_compute_stats`, `_normalize`): fp32 mean and E[x^2] over the valid
    rows x H x W, var = max(E[x^2] - E[x]^2, 0), then
    y = (x - mean) * (rsqrt(var + eps) * weight) + bias over every row.

    A bf16 input is promoted to fp32 for all of it, and y rounds to bf16
    once, as flax's `dtype=bf16` BatchNorm rounds. Its backward follows
    the gradient JAX takes of that: x enters twice, through the cast in
    the statistics and through the promotion in x - mean, so dx is the
    bf16 sum of the two fp32 parts, each rounded to bf16 (two
    convert_element_type transposes and a bf16 add_any in the jaxpr of
    jax.grad).

    The backward is the closed form of that expression, gradients through
    the batch statistics included. It saves the input and per-channel
    vectors only, as the native BN does.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, mask, eps):
        B, C, H, W = x.shape
        dims = (0, 2, 3)
        xf = x.float()
        if mask is None:
            count = B * H * W
            mean = xf.sum(dims) / count
            mu2 = (xf * xf).sum(dims) / count
        else:
            xm = xf * mask.view(B, 1, 1, 1)
            count = mask.sum() * (H * W)
            mean = xm.sum(dims) / count
            mu2 = (xm * xf).sum(dims) / count
        var_raw = mu2 - mean * mean
        var = var_raw.clamp_min(0.0)
        r = torch.rsqrt(var + eps)
        y = ((xf - mean.view(1, C, 1, 1)) * (r * weight).view(1, C, 1, 1)
             + bias.view(1, C, 1, 1))
        ctx.save_for_backward(x, weight, mean, r, var_raw > 0, mask)
        ctx.count = count
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, r, var_pos, mask = ctx.saved_tensors
        B, C, H, W = x.shape
        dims = (0, 2, 3)
        xf, dy = x.float(), dy.float()

        def ch(v):
            return v.view(1, C, 1, 1)

        s = (dy * (xf - ch(mean))).sum(dims)
        dbias = dy.sum(dims)
        dweight = s * r
        g = weight * r
        # through var = max(mu2 - mean^2, 0) into mean and mu2 = E[x^2]
        dvar = torch.where(var_pos, -0.5 * s * weight * r * r * r, 0.0)
        dmean = -dbias * g - 2.0 * mean * dvar
        stat = ch(dmean / ctx.count) + xf * ch(2.0 * dvar / ctx.count)
        if mask is not None:
            stat = stat * mask.view(B, 1, 1, 1)
        direct = dy * ch(g)
        if x.dtype == torch.float32:
            dx = direct + stat
        else:
            dx = direct.to(x.dtype) + stat.to(x.dtype)
        return dx, dweight, dbias, None, None


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d(eps=1e-5, momentum=0.1) with running statistics.

    Eval mode: fp32 arithmetic from the running statistics, the result in
    x.dtype. Train mode (fp32 or bf16): batch statistics in fp32 over the
    rows that `mask` (bn_row_mask) marks valid, the result in x.dtype, and
    running = 0.9 * running + 0.1 * batch (fp32) with the biased batch
    variance, as flax updates it. `num_batches_tracked` is kept for the
    state-dict keys and not used.

    `recomputing` is set while torch.utils.checkpoint recomputes a block
    in the backward (models/resnet.py remat): the recomputation then leaves
    the running statistics alone, so a step updates them once.
    """

    recomputing = False

    def forward(self, x, mask=None):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        y, mean, var = _MaskedBatchNorm.apply(x, self.weight, self.bias,
                                              mask, self.eps)
        if not self.recomputing:
            with torch.no_grad():
                self.running_mean.mul_(1.0 - self.momentum).add_(
                    self.momentum * mean)
                self.running_var.mul_(1.0 - self.momentum).add_(
                    self.momentum * var)
        return y


def run_seq(seq: nn.Sequential, x, mask=None):
    """Apply an nn.Sequential, handing the BN row mask to its BatchNorm2d
    children (Sequential itself passes one argument)."""
    for m in seq:
        x = m(x, mask) if isinstance(m, BatchNorm2d) else m(x)
    return x


class ConvTranspose2d(nn.ConvTranspose2d):
    """ConvTranspose2d(k=4, s=2, p=1, no bias), computing in x.dtype
    (layers.py:85-117; the flax kernel (kh, kw, O, I) is this weight
    (I, O, kh, kw) transposed)."""

    def __init__(self, in_channels, out_channels):
        super().__init__(in_channels, out_channels, 4, stride=2, padding=1,
                         bias=False)

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight.to(x.dtype), None,
                                  self.stride, self.padding)


def max_pool(x):
    """MaxPool2d(3, 2, 1), padding with -inf."""
    return F.max_pool2d(x, 3, 2, 1)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator):
    """Seeded init after the JAX package's initialisers: He-normal (fan-in)
    convs, N(0, 0.001) transposed convs and heatmap head (`final_layer`),
    zero biases, identity BN. The generator lives on the CPU, so call this
    before moving the module to a device."""
    for name, m in module.named_modules():
        if isinstance(m, nn.ConvTranspose2d):
            m.weight.normal_(0.0, 0.001, generator=generator)
        elif isinstance(m, nn.Conv2d):
            if name.endswith("final_layer"):
                std = 0.001
            else:
                std = math.sqrt(2.0 / (m.weight[0].numel()))
            m.weight.normal_(0.0, std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
