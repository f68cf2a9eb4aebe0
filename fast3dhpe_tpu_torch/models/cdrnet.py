"""CDRNet: camera-disentangled stereo 3D pose network.
Port of fast3dhpe_tpu/models/cdrnet.py.

The views are stacked into the batch for the shared encoder and decoder,
the heatmaps decode with the soft-argmax kernel (ops/softargmax.py), and
one batched Jacobi-SVD DLT triangulates every (sample, joint).
"""

from __future__ import annotations

import torch
from torch import nn

from ..geometry.triangulation import dlt_triangulate, pinv_projection
from ..ops.softargmax import soft_argmax_fused
from .decoder import PoseDecoder
from .layers import BatchNorm2d, Conv2d
from .resnet import ResNetEncoder

# CanonicalFusion widths and views, as the JAX package's defaults
HID_CH1, HID_CH2, N_VIEWS = 300, 400, 2


def ftl(x, proj, n_groups: int):
    """Feature Transform Layer: mix channel groups with a matrix.

    The C = N * g channels of x (B, C, H, W) are N-vectors grouped
    channel-major, channel n * g + i in group i (cdrnet.py:34-54), and
    proj (B, M, N) left-multiplies each. proj is cast to x.dtype first, as
    in JAX, so a bf16 network rounds P. Returns (B, M * g, H, W).
    """
    N = proj.shape[-1]
    out = torch.einsum("bmn,bnghw->bmghw", proj.to(x.dtype),
                       x.unflatten(1, (N, n_groups)))
    return out.flatten(1, 2).contiguous(memory_format=torch.channels_last)


def _conv_bn_relu(cin, cout):
    return [Conv2d(cin, cout, 1, 1, 0, bias=True), BatchNorm2d(cout),
            nn.ReLU()]


class CanonicalFusion(nn.Module):
    """Fuse the views' features in a camera-disentangled canonical space:
    in_dim -> 1x1 -> 300 -> FTL(P^-1) -> 400 per view -> concat views ->
    two 1x1 -> 400 -> FTL(P) -> 300 -> per-view 1x1 -> in_dim."""

    def __init__(self, in_dim=2048):
        super().__init__()
        self.conv_layer1 = nn.Sequential(*_conv_bn_relu(in_dim, HID_CH1))
        self.conv_layer2 = nn.Sequential(
            *_conv_bn_relu(N_VIEWS * HID_CH2, HID_CH2),
            *_conv_bn_relu(HID_CH2, HID_CH2))
        self.out_layer = nn.ModuleList(
            nn.Sequential(*_conv_bn_relu(HID_CH1, in_dim))
            for _ in range(N_VIEWS))

    def forward(self, zs, proj, proj_inv):
        """zs: (B*V, C, h, w), view-major rows; proj (B, V, 3, 4);
        proj_inv (B, V, 4, 3). Returns (B*V, C, h, w)."""
        B, V = proj.shape[:2]
        x = self.conv_layer1(zs)
        z = ftl(x, proj_inv.reshape(B * V, 4, 3), HID_CH1 // 3)
        # concat the views along channels, view-major (cdrnet.py:104-106)
        z = z.reshape(B, V * HID_CH2, *z.shape[2:])
        f = self.conv_layer2(z.contiguous(memory_format=torch.channels_last))
        back = ftl(f.repeat_interleave(V, dim=0), proj.reshape(B * V, 3, 4),
                   HID_CH2 // 4)
        back = back.unflatten(0, (B, V))
        outs = [self.out_layer[i](back[:, i]) for i in range(V)]
        out = torch.stack(outs, dim=1).flatten(0, 1)
        return out.contiguous(memory_format=torch.channels_last)


class CDRNet(nn.Module):
    """Stereo 3D network: (B, V, H, W, 3) images, (B, V, 3, 4) projections
    -> pred_2d (B, V, J, 2) image pixels, pred_3d (B, J, 3).

    Parameters are fp32; `dtype` is the compute dtype of the encoder,
    fusion and decoder. The decode and the geometry run in fp32.
    """

    def __init__(self, num_joints=19, num_layers=101, dlt_method="jacobi",
                 fused_inference=False, dtype=torch.float32):
        super().__init__()
        self.num_joints = num_joints
        self.dlt_method = dlt_method
        self.dtype = dtype
        self.encoder = ResNetEncoder(num_layers, fused_inference)
        in_dim = self.encoder.out_channels
        self.CF = CanonicalFusion(in_dim)
        self.decoder = PoseDecoder(in_dim, num_joints)

    @classmethod
    def from_config(cls, cfg, dtype=torch.float32, fused_inference=False):
        return cls(num_joints=cfg.MODEL.NUM_JOINTS,
                   num_layers=cfg.MODEL.NUM_LAYERS,
                   dlt_method=cfg.MODEL.EXTRA.DLT_METHOD,
                   fused_inference=fused_inference, dtype=dtype)

    def forward(self, imgs, projs, return_heatmaps: bool = False):
        """imgs (B, V, H, W, 3) normalised; projs (B, V, 3, 4).

        Returns (pred_2d, pred_3d), plus the raw heatmaps (B, V, h, w, J)
        in the compute dtype with return_heatmaps=True.
        """
        B, V, H, W, _ = imgs.shape
        if V != N_VIEWS:
            raise ValueError(f"expected {N_VIEWS} views, got {V}")
        projs = projs.float()
        x = imgs.reshape(B * V, H, W, 3).to(self.dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        z = self.encoder(x)
        fused = self.CF(z, projs, pinv_projection(projs))
        h = self.decoder(fused)                        # (B*V, J, hh, hw)
        hm = h.permute(0, 2, 3, 1)                     # (B*V, hh, hw, J)
        kp = soft_argmax_fused(hm) * (H / hm.shape[1])
        kp = kp.reshape(B, V, self.num_joints, 2)
        proj_j = projs[:, None].expand(B, self.num_joints, V, 3, 4)
        pred_3d = dlt_triangulate(proj_j, kp.transpose(1, 2),
                                  method=self.dlt_method)
        if return_heatmaps:
            return kp, pred_3d, hm.reshape(B, V, *hm.shape[1:])
        return kp, pred_3d
