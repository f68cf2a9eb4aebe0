"""Layer primitives. Port of fast3dhpe_tpu/models/layers.py.

Parameters are fp32. Each layer computes in the dtype of its input, casting
its weights to it explicitly, so a bf16 network rounds where flax's
`dtype=bf16` layers round: a conv rounds its output to bf16 and then adds
its bias in bf16; eval-mode BN computes in fp32 from the bf16 input and
rounds once. (Autocast would keep BN in fp32 and round elsewhere.)

Activations are NCHW tensors in channels_last memory, so cuDNN runs NHWC.
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


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d(eps=1e-5) with running statistics: fp32 arithmetic, the
    result in x.dtype."""

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "train-mode BatchNorm (masked batch statistics) is not "
                "ported yet; call .eval()")
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


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
