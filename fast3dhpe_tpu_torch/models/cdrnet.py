"""CDRNet: camera-disentangled stereo 3D pose network.
Port of fast3dhpe_tpu/models/cdrnet.py.

The views are stacked into the batch for the shared encoder and decoder,
the heatmaps decode with the soft-argmax kernel (ops/softargmax.py), and
one batched Jacobi-SVD DLT triangulates every (sample, joint).

On a spatial mesh (parallel/spatial.py) each model rank runs the encoder
on its rows of the images. Where the split holds through the encoder, the
fusion and the decoder run on the rank's rows too and the soft-argmax
combines the ranks' K1 statistics (split_soft_argmax), so every model
rank triangulates the same keypoints bit for bit; where the encoder
gathered, they run whole on every model rank and the soft-argmax is one
K1 launch, so each rank's keypoints are its own run of the unsplit
shapes (on the card as far apart as two runs of the unsplit forward).
"""

from __future__ import annotations

import torch
from torch import nn

from ..geometry.graphed import GraphedGeometry
from ..geometry.triangulation import dlt_triangulate, pinv_projection
from ..parallel.spatial import spatial_of, split_after, split_soft_argmax
from .decoder import PoseDecoder
from .layers import BatchNorm2d, Conv2d, bn_row_mask, run_seq
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

    def forward(self, zs, proj, proj_inv, mask=None):
        """zs: (B*V, C, h, w), rows b-major (row b * V + v); proj
        (B, V, 3, 4); proj_inv (B, V, 4, 3); mask: the (B,) BN row mask
        (layers.bn_row_mask) or None. Returns (B*V, C, h, w).

        The view-stacked BN site (conv_layer1) takes the mask repeated per
        view, b-major as the rows; conv_layer2 and out_layer take (B,).
        """
        B, V = proj.shape[:2]
        mask_bv = None if mask is None else mask.repeat_interleave(V, dim=0)
        x = run_seq(self.conv_layer1, zs, mask_bv)
        z = ftl(x, proj_inv.reshape(B * V, 4, 3), HID_CH1 // 3)
        # concat the views along channels, view-major (cdrnet.py:104-106)
        z = z.reshape(B, V * HID_CH2, *z.shape[2:])
        f = run_seq(self.conv_layer2,
                    z.contiguous(memory_format=torch.channels_last), mask)
        back = ftl(f.repeat_interleave(V, dim=0), proj.reshape(B * V, 3, 4),
                   HID_CH2 // 4)
        back = back.unflatten(0, (B, V))
        outs = [run_seq(self.out_layer[i], back[:, i], mask)
                for i in range(V)]
        out = torch.stack(outs, dim=1).flatten(0, 1)
        return out.contiguous(memory_format=torch.channels_last)


class CDRNet(nn.Module):
    """Stereo 3D network: (B, V, H, W, 3) images, (B, V, 3, 4) projections
    -> pred_2d (B, V, J, 2) image pixels, pred_3d (B, J, 3).

    Parameters are fp32; `dtype` is the compute dtype of the encoder,
    fusion and decoder. The decode and the geometry run in fp32. In train
    mode (`.train()`) every BN takes batch statistics over the valid rows
    of `row_valid`, in fp32 whatever the compute dtype. In eval mode on
    CUDA without autograd, the pinv and the Jacobi DLT replay CUDA graphs
    of the instance's own `geometry` (geometry/graphed.py). remat and
    remat_policy rematerialise the encoder's blocks in the backward
    (models/resnet.py). On a spatial mesh (`spatial`, set by
    parallel/mesh.py replicate) the images are this model rank's rows, in
    eval mode only.
    """

    spatial = None

    def __init__(self, num_joints=19, num_layers=101, dlt_method="jacobi",
                 fused_inference=False, dtype=torch.float32, remat=False,
                 remat_policy=None):
        super().__init__()
        self.num_joints = num_joints
        self.dlt_method = dlt_method
        self.dtype = dtype
        self.encoder = ResNetEncoder(num_layers, fused_inference, remat,
                                     remat_policy)
        in_dim = self.encoder.out_channels
        self.CF = CanonicalFusion(in_dim)
        self.decoder = PoseDecoder(in_dim, num_joints)
        self.geometry = GraphedGeometry()

    @classmethod
    def from_config(cls, cfg, dtype=torch.float32, fused_inference=False):
        return cls(num_joints=cfg.MODEL.NUM_JOINTS,
                   num_layers=cfg.MODEL.NUM_LAYERS,
                   dlt_method=cfg.MODEL.EXTRA.DLT_METHOD,
                   fused_inference=fused_inference, dtype=dtype)

    def forward(self, imgs, projs, return_heatmaps: bool = False,
                row_valid=None, valid_rows=None):
        """imgs (B, V, H, W, 3) normalised; projs (B, V, 3, 4); row_valid
        optional (B,) 0/1, read by train-mode BN only; valid_rows the
        global count of valid rows under a process group (bn_row_mask).

        Returns (pred_2d, pred_3d), plus the raw heatmaps (B, V, h, w, J)
        in the compute dtype with return_heatmaps=True. On a spatial mesh
        imgs hold this model rank's rows of H, and the heatmaps are its
        rows of h where the split holds through the encoder
        (parallel/spatial.py heatmap_split), else whole; pred_2d and
        pred_3d are the whole image's on every model rank.
        """
        B, V, H, W, _ = imgs.shape
        if V != N_VIEWS:
            raise ValueError(f"expected {N_VIEWS} views, got {V}")
        mesh = spatial_of(self)
        mask = bn_row_mask(row_valid, valid_rows)      # (B,)
        # the views are stacked b-major, so the mask repeats per view
        # (jnp.repeat(mask, V, axis=0)), not tiled
        mask_bv = None if mask is None else mask.repeat_interleave(V, dim=0)
        projs = projs.float()
        x = imgs.reshape(B * V, H, W, 3).to(self.dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        z = self.encoder(x, mask_bv, mesh)
        split = split_after(mesh, H, self.encoder.ops)
        # the functions are looked up here, as an eager call would, and
        # captured as they stand at a shape's capture
        proj_inv = self.geometry.run("pinv", pinv_projection, (projs,),
                                     not self.training)
        fused = self.CF(z, projs, proj_inv, mask)
        h = self.decoder(fused, mask_bv, split)        # (B*V, J, hh, hw)
        # (B*V, hh, hw, J): a view of the channels_last output, which K1
        # takes as it is; contiguous() is a no-op then, and keeps an
        # exported graph, whose tracer assumed NCHW strides, right
        hm = h.permute(0, 2, 3, 1).contiguous()
        if mesh is not None and split is None:
            H *= mesh.model_size           # gathered: the whole image's
        kp = split_soft_argmax(hm, split) * (H / hm.shape[1])
        kp = kp.reshape(B, V, self.num_joints, 2)

        def triangulate(projs, kp):
            proj_j = projs[:, None].expand(B, self.num_joints, V, 3, 4)
            return dlt_triangulate(proj_j, kp.transpose(1, 2),
                                   method=self.dlt_method)

        # svd and sii sync with the host, which a capture cannot hold
        pred_3d = self.geometry.run(
            "dlt", triangulate, (projs, kp),
            not self.training and self.dlt_method == "jacobi")
        if return_heatmaps:
            return kp, pred_3d, hm.reshape(B, V, *hm.shape[1:])
        return kp, pred_3d
