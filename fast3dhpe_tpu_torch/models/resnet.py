"""ResNet encoder (18/34/50/101/152). Port of fast3dhpe_tpu/models/resnet.py.

BasicBlock keeps the JAX package's canonical form (stride on conv1 only).
Bottleneck keeps its opt-in fused inference path: with fused_inference=True,
eval-mode stride-1 bf16 blocks that pass `Bottleneck.fusable` run as one
launch of the fused-bottleneck kernel (ops/bottleneck.py).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from ..ops.bottleneck import fold_bn, fused_bottleneck
from .layers import BatchNorm2d, Conv2d, max_pool

# depth -> (block type, blocks per stage)
RESNET_SPEC = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}
EXPANSION = {"basic": 1, "bottleneck": 4}


def _downsample(cin, cout, stride):
    return nn.Sequential(Conv2d(cin, cout, 1, stride, 0, bias=False),
                         BatchNorm2d(cout))


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block, stride on conv1 only."""

    def __init__(self, inplanes, planes, stride=1, downsample=False):
        super().__init__()
        self.stride = stride
        self.conv1 = Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = (_downsample(inplanes, planes, stride)
                           if downsample else None)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (x4) residual block."""

    def __init__(self, inplanes, planes, stride=1, downsample=False,
                 fused_inference=False):
        super().__init__()
        self.planes = planes
        self.stride = stride
        self.fused_inference = fused_inference
        self.conv1 = Conv2d(inplanes, planes, 1, 1, 0, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, 1, 0, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = (_downsample(inplanes, planes * 4, stride)
                           if downsample else None)

    def fusable(self, H: int, W: int, dtype) -> bool:
        """The fused-kernel gate: whether an input of this spatial size and
        dtype takes the kernel. It reproduces the JAX gate
        (models/resnet.py:107-118) exactly, VMEM estimate included, so both
        packages fuse the same blocks."""
        if (not self.fused_inference or self.training or self.stride != 1
                or dtype != torch.bfloat16):
            return False
        cin, P = self.conv1.in_channels, self.planes
        vmem = 2 * H * W * (2 * cin + 2 * 4 * P + 9 * P + P)
        return vmem < 13 * 2 ** 20 and H * W >= 1024

    def _fused(self, x):
        def folded(bn):
            return fold_bn(bn.weight, bn.bias, bn.running_mean,
                           bn.running_var, bn.eps)

        s1, b1 = folded(self.bn1)
        s2, b2 = folded(self.bn2)
        s3, b3 = folded(self.bn3)
        w1 = self.conv1.weight[:, :, 0, 0].t()              # (Cin, P)
        w2 = self.conv2.weight.permute(2, 3, 1, 0)          # (3, 3, P, P)
        w3 = self.conv3.weight[:, :, 0, 0].t()              # (P, 4P)
        wd = sd = bd = None
        if self.downsample is not None:
            wd = self.downsample[0].weight[:, :, 0, 0].t()  # (Cin, 4P)
            sd, bd = folded(self.downsample[1])
        return fused_bottleneck(x, w1, s1, b1, w2, s2, b2, w3, s3, b3,
                                wd, sd, bd)

    def forward(self, x):
        if self.fusable(x.shape[2], x.shape[3], x.dtype):
            return self._fused(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


def _conv_out(size: int, k: int, s: int, p: int) -> int:
    return (size + 2 * p - k) // s + 1


class ResNetEncoder(nn.Module):
    """(B, 3, H, W) -> (B, 512 * expansion, H/32, W/32)."""

    def __init__(self, num_layers=101, fused_inference=False):
        super().__init__()
        block_name, stage_sizes = RESNET_SPEC[num_layers]
        expansion = EXPANSION[block_name]
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        inplanes = 64
        for stage, (planes, blocks) in enumerate(
                zip((64, 128, 256, 512), stage_sizes), start=1):
            layer = []
            for i in range(blocks):
                s = (1 if stage == 1 else 2) if i == 0 else 1
                downsample = i == 0 and (s != 1
                                         or inplanes != planes * expansion)
                if block_name == "bottleneck":
                    layer.append(Bottleneck(inplanes, planes, s, downsample,
                                            fused_inference))
                else:
                    layer.append(BasicBlock(inplanes, planes, s, downsample))
                inplanes = planes * expansion
            setattr(self, f"layer{stage}", nn.Sequential(*layer))
        self.out_channels = inplanes

    def blocks(self):
        for stage in range(1, 5):
            for i, blk in enumerate(getattr(self, f"layer{stage}")):
                yield f"layer{stage}.{i}", blk

    def fused_blocks(self, image_hw: Tuple[int, int], dtype) -> List[str]:
        """Names of the blocks that take the fused kernel for an input of
        this size and dtype, from shapes alone (no forward pass)."""
        H, W = (_conv_out(_conv_out(d, 7, 2, 3), 3, 2, 1) for d in image_hw)
        names = []
        for name, blk in self.blocks():
            if isinstance(blk, Bottleneck) and blk.fusable(H, W, dtype):
                names.append(name)
            H, W = (_conv_out(d, 3, blk.stride, 1) for d in (H, W))
        return names

    def forward(self, x):
        x = max_pool(torch.relu(self.bn1(self.conv1(x))))
        for _, blk in self.blocks():
            x = blk(x)
        return x
