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

Given a spatial mesh (`mesh=`, which the networks hand down while the
split holds; parallel/spatial.py), the convolutions, the transposed
convolution and the max-pool take their halo rows from the neighbouring
model ranks, run with H padding 0 and keep their W padding; eval-mode BN
is per channel and stays local. Without one (None) they run whole.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.batchnorm import train_bn_backward, train_bn_forward
from ..parallel.spatial import deconv_rows, window_rows


class Conv2d(nn.Conv2d):
    """Conv2d with symmetric integer padding, computing in x.dtype. Given
    a spatial mesh it reads its halo rows (conv_halo) from the
    neighbouring model ranks, zeros at the global edge, as its own padding
    would be."""

    def forward(self, x, mesh=None):
        x, pad = window_rows(x, 2, self.kernel_size[0], self.stride[0],
                             self.padding[0], mesh, 0.0)
        y = F.conv2d(x, self.weight.to(x.dtype), None, self.stride, pad)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype).reshape(1, -1, 1, 1)
        return y


def bn_row_mask(row_valid, valid_rows=None):
    """(B,) 0/1 row validity -> the (B,) fp32 BN mask (layers.py:47-64).

    Padded loader rows stay out of train-mode batch statistics. A global
    batch with no valid row falls back to the whole batch instead of
    empty-set NaN statistics. No host sync: the fallback is a tensor op.

    valid_rows: under a process group, the GLOBAL count of valid rows
    (parallel/mesh.py row_counts), so that a rank whose rows are all
    filler keeps them out while another rank has valid rows; None when the
    local batch is the global one.
    """
    if row_valid is None:
        return None
    m = torch.as_tensor(row_valid) > 0
    any_valid = m.any() if valid_rows is None else valid_rows > 0
    return (m | ~any_valid).float()


class _MaskedBatchNorm(torch.autograd.Function):
    """Train-mode BN over NCHW (NCDHW for BatchNorm3d) with batch
    statistics from the masked rows, as flax's BatchNorm computes them
    with `mask=` (flax 0.12.3
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

    With a process group the batch is the ranks' rows together, as under
    the JAX package's mesh: the forward all-reduces one packed tensor of
    the masked sums, sums of squares and count, and the backward one of
    the two sums that carry the statistics' gradient into dx. dweight and
    dbias stay the local rank's share, which the step's gradient
    all-reduce sums. At world size 1 every reduction is an identity, so
    the arithmetic is the one without a group, bit for bit.

    The arithmetic is ops/batchnorm.py's: on CPU tensors its plain version
    in eager PyTorch, on CUDA tensors the kernels of csrc/batchnorm.cu
    (three launches each way), which raise on a layout they do not take.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, mask, eps, group):
        y, mean, var, saved, count = train_bn_forward(x, weight, bias, mask,
                                                      eps, group)
        ctx.save_for_backward(x, weight, mask, *saved)
        ctx.count = count
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mask, *saved = ctx.saved_tensors
        dx, dweight, dbias = train_bn_backward(dy, x, weight, mask, saved,
                                               ctx.count, ctx.group)
        return dx, dweight, dbias, None, None, None


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
    the running statistics alone, so a step updates them once. It still
    reduces over the process group, since every rank recomputes the same
    blocks.

    `process_group` (parallel/mesh.py replicate sets it) makes train mode
    take the statistics of the ranks' rows together; the running
    statistics then update from the global mean and biased variance, the
    same on every rank.
    """

    recomputing = False
    process_group = None

    def forward(self, x, mask=None):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        y, mean, var = _MaskedBatchNorm.apply(x, self.weight, self.bias,
                                              mask, self.eps,
                                              self.process_group)
        if not self.recomputing:
            with torch.no_grad():
                self.running_mean.mul_(1.0 - self.momentum).add_(
                    self.momentum * mean)
                self.running_var.mul_(1.0 - self.momentum).add_(
                    self.momentum * var)
        return y


class BatchNorm3d(BatchNorm2d):
    """BatchNorm2d's arithmetic over (N, C, D, H, W) volumes (the V2V of
    models/volumetric.py). A subclass, so that whatever sets up a
    BatchNorm2d (run_seq's row mask, replicate's process group, remat's
    flag) sets this up too."""


def run_seq(seq: nn.Sequential, x, mask=None, mesh=None):
    """Apply an nn.Sequential, handing the BN row mask to its BatchNorm2d
    children and the spatial mesh (or None) to its convolutions
    (Sequential itself passes one argument)."""
    for m in seq:
        if isinstance(m, BatchNorm2d):
            x = m(x, mask)
        elif isinstance(m, (Conv2d, ConvTranspose2d)):
            x = m(x, mesh)
        else:
            x = m(x)
    return x


class ConvTranspose2d(nn.ConvTranspose2d):
    """ConvTranspose2d(k=4, s=2, p=1, no bias), computing in x.dtype
    (layers.py:85-117; the flax kernel (kh, kw, O, I) is this weight
    (I, O, kh, kw) transposed). Given a spatial mesh it reads one row of
    each neighbouring model rank (zeros at the global edge) and crops the
    three output rows on each side that belong to them (deconv_halo)."""

    def __init__(self, in_channels, out_channels):
        super().__init__(in_channels, out_channels, 4, stride=2, padding=1,
                         bias=False)

    def forward(self, x, mesh=None):
        w = self.weight.to(x.dtype)
        return deconv_rows(
            lambda x, pad: F.conv_transpose2d(x, w, None, self.stride, pad),
            x, 2, self.kernel_size[0], self.stride[0], self.padding[0], mesh)


def max_pool(x, mesh=None):
    """MaxPool2d(3, 2, 1), padding with -inf; given a spatial mesh with the
    row above the rank's block from its upper neighbour (-inf at the
    global top)."""
    x, pad = window_rows(x, 2, 3, 2, 1, mesh, float("-inf"))
    return F.max_pool2d(x, 3, 2, pad)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator):
    """Seeded init after the JAX package's initialisers: He-normal (fan-in)
    convs, N(0, 0.001) transposed convs and heatmap head (`final_layer`),
    zero biases, identity BN; Xavier-normal 3D convolutions. The generator
    lives on the CPU, so call this before moving the module to a device."""
    for name, m in module.named_modules():
        if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
            # Xavier-normal, as the V2V's own initialiser
            fan = m.weight[0].numel() + m.weight[:, 0].numel()
            m.weight.normal_(0.0, math.sqrt(2.0 / fan), generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.ConvTranspose2d):
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
