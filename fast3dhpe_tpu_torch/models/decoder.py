"""Deconvolutional heatmap decoder. Port of fast3dhpe_tpu/models/decoder.py:
3 x (ConvTranspose2d k4 s2 p1 + BN + ReLU), then a 1x1 conv with bias to
the joints (none with num_joints=None). Given a spatial mesh each
transposed convolution takes its halo rows itself (models/layers.py
ConvTranspose2d); the BNs and the 1x1 head are per pixel."""

from __future__ import annotations

import torch
from torch import nn

from .layers import BatchNorm2d, Conv2d, ConvTranspose2d, run_seq


class PoseDecoder(nn.Module):
    def __init__(self, in_channels, num_joints, num_deconv_filters=256):
        super().__init__()
        ch = in_channels
        for i in (1, 2, 3):
            setattr(self, f"deconv{i}", nn.Sequential(
                ConvTranspose2d(ch, num_deconv_filters),
                BatchNorm2d(num_deconv_filters)))
            ch = num_deconv_filters
        # num_joints None: no head, the features are the output (the
        # volumetric network's trunk, models/volumetric.py)
        self.final_layer = (None if num_joints is None else
                            Conv2d(ch, num_joints, 1, 1, 0, bias=True))

    def forward(self, x, mask=None, mesh=None):
        """mask: the (B,) BN row mask (layers.bn_row_mask) of x's rows;
        mesh: the spatial mesh when x is this model rank's rows, else
        None."""
        for i in (1, 2, 3):
            x = torch.relu(run_seq(getattr(self, f"deconv{i}"), x, mask,
                                   mesh))
        return x if self.final_layer is None else self.final_layer(x)
