"""Learnable Triangulation's volumetric network (Iskakov, Burkov,
Lempitsky, Malkov, ICCV 2019, arXiv:1905.05754), after its public code:
mvn/models/triangulation.py VolumetricTriangulationNet and
mvn/models/v2v.py V2VModel, with the module names of that code under
`volume_net` and `process_features`.

A forward of B samples of V views:
1. the trunk, the port's ResNet encoder (models/resnet.py) and the three
   deconvolutions of models/decoder.py, gives 256 features at a quarter
   of the image on each view. The public trunk's 2D heatmap head is left
   out: the volumetric model never reads it, so it moves no output and no
   gradient;
2. a 1x1 convolution reduces them to 32;
3. geometry/volume.py lifts them into a cuboid of size^3 voxels, 2,500 mm
   a side, about the root joint, turned by `theta` about the vertical
   axis, the views merged by a softmax over them;
4. the V2V encoder-decoder gives one volume a joint;
5. a 3D soft-argmax over the voxel centres (two K1 launches,
   geometry/volume.py soft_argmax_3d) gives the joints in mm.

The trunk computes in `dtype`; the volume path in fp32. In train mode
every BN, the V2V's 3D ones included (layers.BatchNorm3d), takes batch
statistics over the valid rows of `row_valid`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..geometry.volume import (coord_volume, resize_projection,
                               soft_argmax_3d, unproject, voxels_to_world)
from .decoder import PoseDecoder
from .layers import BatchNorm3d, Conv2d, bn_row_mask, run_seq
from .resnet import ResNetEncoder


def _basic(cin, cout, k):
    return nn.Sequential(nn.Conv3d(cin, cout, k, 1, (k - 1) // 2),
                         BatchNorm3d(cout), nn.ReLU(inplace=True))


class Basic3DBlock(nn.Module):
    """conv k^3 -> BN -> ReLU."""

    def __init__(self, cin, cout, k):
        super().__init__()
        self.block = _basic(cin, cout, k)

    def forward(self, x, mask=None):
        return run_seq(self.block, x, mask)


class Res3DBlock(nn.Module):
    """conv 3^3 -> BN -> ReLU -> conv 3^3 -> BN, plus the input (or its
    conv 1^3 -> BN where the widths differ), then ReLU."""

    def __init__(self, cin, cout):
        super().__init__()
        self.res_branch = nn.Sequential(
            nn.Conv3d(cin, cout, 3, 1, 1), BatchNorm3d(cout),
            nn.ReLU(inplace=True), nn.Conv3d(cout, cout, 3, 1, 1),
            BatchNorm3d(cout))
        self.skip_con = (nn.Sequential() if cin == cout else nn.Sequential(
            nn.Conv3d(cin, cout, 1, 1, 0), BatchNorm3d(cout)))

    def forward(self, x, mask=None):
        res = run_seq(self.res_branch, x, mask)
        return torch.relu_(res + run_seq(self.skip_con, x, mask))


class Upsample3DBlock(nn.Module):
    """ConvTranspose3d k2 s2 -> BN -> ReLU."""

    def __init__(self, cin, cout):
        super().__init__()
        self.block = nn.Sequential(nn.ConvTranspose3d(cin, cout, 2, 2),
                                   BatchNorm3d(cout), nn.ReLU(inplace=True))

    def forward(self, x, mask=None):
        return run_seq(self.block, x, mask)


LEVELS = 5              # the encoder-decoder's poolings
FEATURES = 32           # channels lifted into the cuboid
CUBOID_SIDE = 2500.0    # mm
CE_WEIGHT = 0.01        # the volumetric cross-entropy's weight in the loss
HEAD_LR_SCALE = 10.0    # the reduction's and the V2V's LR over the trunk's
_ENC = ((32, 64), (64, 128), (128, 128), (128, 128), (128, 128))


class EncoderDecoder(nn.Module):
    """Five levels: a skip block on each level's input, then max-pool 2
    and a residual block; a middle block; then per level, from the
    deepest, a residual block, an upsampling and the skip added."""

    def __init__(self):
        super().__init__()
        for i, (cin, cout) in enumerate(_ENC, start=1):
            setattr(self, f"encoder_res{i}", Res3DBlock(cin, cout))
            setattr(self, f"skip_res{i}", Res3DBlock(cin, cin))
            setattr(self, f"decoder_res{i}", Res3DBlock(cout, cout))
            setattr(self, f"decoder_upsample{i}", Upsample3DBlock(cout, cin))
        self.mid_res = Res3DBlock(128, 128)

    def forward(self, x, mask=None):
        skips = []
        for i in range(1, LEVELS + 1):
            skips.append(getattr(self, f"skip_res{i}")(x, mask))
            x = getattr(self, f"encoder_res{i}")(F.max_pool3d(x, 2, 2), mask)
        x = self.mid_res(x, mask)
        for i in range(LEVELS, 0, -1):
            x = getattr(self, f"decoder_res{i}")(x, mask)
            x = getattr(self, f"decoder_upsample{i}")(x, mask) + skips[i - 1]
        return x


class V2VModel(nn.Module):
    """(B, cin, D, H, W) -> (B, cout, D, H, W), D, H and W divisible by
    2^5: front layers, the encoder-decoder, back layers, a 1^3 conv."""

    def __init__(self, cin, cout):
        super().__init__()
        self.front_layers = nn.ModuleList([
            Basic3DBlock(cin, 16, 7), Res3DBlock(16, 32), Res3DBlock(32, 32),
            Res3DBlock(32, 32)])
        self.encoder_decoder = EncoderDecoder()
        self.back_layers = nn.ModuleList([
            Res3DBlock(32, 32), Basic3DBlock(32, 32, 1),
            Basic3DBlock(32, 32, 1)])
        self.output_layer = nn.Conv3d(32, cout, 1, 1, 0)

    def forward(self, x, mask=None):
        for m in self.front_layers:
            x = m(x, mask)
        x = self.encoder_decoder(x, mask)
        for m in self.back_layers:
            x = m(x, mask)
        return self.output_layer(x)


class VolumetricNet(nn.Module):
    """Stereo (or multi-view) volumetric network: (B, V, H, W, 3) images,
    (B, V, 3, 4) projections to image pixels, the cuboid's centre (B, 3)
    and turn (B,) -> pred_3d (B, J, 3) in mm.

    Parameters are fp32; `dtype` is the trunk's compute dtype."""

    spatial = None

    def __init__(self, num_joints=19, num_layers=152, volume_size=64,
                 dtype=torch.float32):
        super().__init__()
        self.num_joints = num_joints
        self.volume_size = volume_size
        self.cuboid_side = CUBOID_SIDE
        self.dtype = dtype
        self.encoder = ResNetEncoder(num_layers)
        self.decoder = PoseDecoder(self.encoder.out_channels, None)
        self.process_features = Conv2d(256, FEATURES, 1, 1, 0, bias=True)
        self.volume_net = V2VModel(FEATURES, num_joints)

    @classmethod
    def from_config(cls, cfg, dtype=torch.float32):
        return cls(num_joints=cfg.MODEL.NUM_JOINTS,
                   num_layers=cfg.MODEL.NUM_LAYERS,
                   volume_size=cfg.MODEL.EXTRA.VOLUME_SIZE, dtype=dtype)

    def param_groups(self):
        """The optimizer's groups: the trunk at the schedule's LR, the
        feature reduction and the V2V at HEAD_LR_SCALE times it (the
        public recipe's three groups: 1e-4, then 1e-3 and 1e-3)."""
        trunk = [p for n, p in self.named_parameters()
                 if n.startswith(("encoder.", "decoder."))]
        head = (list(self.process_features.parameters())
                + list(self.volume_net.parameters()))
        return [{"params": trunk, "lr_scale": 1.0},
                {"params": head, "lr_scale": HEAD_LR_SCALE}]

    def forward(self, imgs, projs, root, theta, row_valid=None,
                valid_rows=None, return_logits: bool = False):
        """imgs (B, V, H, W, 3) normalised; projs (B, V, 3, 4) to image
        pixels; root (B, 3) mm; theta (B,) radians; row_valid and
        valid_rows as CDRNet's. Returns pred_3d (B, J, 3), and with
        return_logits the volumes' logits (B, D, H, W, J), contiguous."""
        B, V, H, W, _ = imgs.shape
        mask = bn_row_mask(row_valid, valid_rows)
        mask_bv = None if mask is None else mask.repeat_interleave(V, dim=0)
        x = imgs.reshape(B * V, H, W, 3).to(self.dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        f = self.decoder(self.encoder(x, mask_bv), mask_bv)
        f = self.process_features(f).float()
        h, w = f.shape[-2:]
        size, side = self.volume_size, self.cuboid_side
        coords = coord_volume(root, theta, size, side)
        vol = unproject(f.reshape(B, V, *f.shape[1:]),
                        resize_projection(projs.float(), (H, W), (h, w)),
                        coords)
        # the published volume_multiplier is 1: the logits as they come
        logits = self.volume_net(vol, mask).permute(0, 2, 3, 4, 1)
        logits = logits.contiguous()
        pred = voxels_to_world(soft_argmax_3d(logits), root, theta, size,
                               side)
        return (pred, logits) if return_logits else pred
