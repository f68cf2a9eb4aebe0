"""PoseResNet: the single-view 2D heatmap network (Simple Baselines).
Port of fast3dhpe_tpu/models/poseresnet.py: ResNet encoder, then the
deconv decoder; (B, H, W, 3) images -> (B, H/4, W/4, J) heatmaps, NHWC as
in the JAX package."""

from __future__ import annotations

import torch
from torch import nn

from .decoder import PoseDecoder
from .layers import bn_row_mask
from .resnet import ResNetEncoder


class PoseResNet(nn.Module):
    """Parameters are fp32; `dtype` is the compute dtype. In train mode
    every BN takes batch statistics over the valid rows of `row_valid`.
    remat and remat_policy rematerialise the encoder's blocks in the
    backward (models/resnet.py)."""

    def __init__(self, num_joints=19, num_layers=101, dtype=torch.float32,
                 remat=False, remat_policy=None):
        super().__init__()
        self.dtype = dtype
        self.encoder = ResNetEncoder(num_layers, remat=remat,
                                     remat_policy=remat_policy)
        self.decoder = PoseDecoder(self.encoder.out_channels, num_joints)

    @classmethod
    def from_config(cls, cfg, dtype=torch.float32):
        return cls(num_joints=cfg.MODEL.NUM_JOINTS,
                   num_layers=cfg.MODEL.NUM_LAYERS, dtype=dtype)

    def forward(self, x, row_valid=None):
        """x (B, H, W, 3) normalised -> heatmaps (B, h, w, J), a view of
        the decoder's channels_last output."""
        mask = bn_row_mask(row_valid)
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        h = self.decoder(self.encoder(x, mask), mask)
        return h.permute(0, 2, 3, 1)
