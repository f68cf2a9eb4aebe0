"""The volumetric model's geometry (models/volumetric.py): the cuboid of
voxel centres around the root joint, the unprojection of the views'
features into it, and the 3D soft-argmax over it. After Learnable
Triangulation's public code (Iskakov et al. 2019, arXiv:1905.05754):
mvn/models/triangulation.py VolumetricTriangulationNet.forward and
mvn/utils/op.py unproject_heatmaps, integrate_tensor_3d_with_coordinates.

The cuboid: voxel (i, j, k) of a size^3 grid lies at
position + s * (i, j, k), position = root - side / 2, s = side / (size - 1),
turned about the root by `theta` radians about the scene's vertical (y)
axis. Every step holds whole batches, not loops over samples and views,
and nothing here reads a tensor back to the host, so a CUDA graph of the
train step captures it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.softargmax import soft_argmax_fused


def rotation_y(theta):
    """(B,) radians -> (B, 3, 3), counter-clockwise about the y axis (the
    public code's rotation_matrix about (0, 1, 0))."""
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(theta), torch.ones_like(theta)
    return torch.stack([c, z, s, z, o, z, -s, z, c], dim=-1).view(-1, 3, 3)


def _grid(size: int, device):
    g = torch.arange(size, dtype=torch.float32, device=device)
    return torch.stack(torch.meshgrid(g, g, g, indexing="ij"), dim=-1)


def coord_volume(root, theta, size: int, side: float):
    """root (B, 3) mm, theta (B,) -> (B, size, size, size, 3) voxel
    centres in mm, computed in the public code's order: position + s * grid,
    less the root, turned, plus the root."""
    step = side / (size - 1)
    position = root - side / 2
    g = position[:, None, None, None] + step * _grid(size, root.device)
    g = g - root[:, None, None, None]
    g = torch.einsum("bij,bdhwj->bdhwi", rotation_y(theta), g)
    return g + root[:, None, None, None]


def voxels_to_world(idx, root, theta, size: int, side: float):
    """Expected voxel indices (B, J, 3) -> (B, J, 3) mm: the cuboid's map
    of an index, affine, so that it takes the expectation of the voxel
    centres to the centre of the expected index exactly."""
    step = side / (size - 1)
    g = (root - side / 2)[:, None] + step * idx - root[:, None]
    return torch.einsum("bij,bnj->bni", rotation_y(theta), g) + root[:, None]


def nearest_voxel(points, root, theta, size: int, side: float):
    """(B, J, 3) mm -> (B, J) flat index (i * size + j) * size + k of the
    voxel whose centre lies nearest: the cuboid is a turned box lattice, so
    that is the point's index in the lattice's frame, rounded and clamped
    on each axis."""
    step = side / (size - 1)
    local = torch.einsum("bji,bnj->bni", rotation_y(theta),
                         points - root[:, None])
    idx = torch.round((local + side / 2) / step).clamp(0, size - 1).long()
    return (idx[..., 0] * size + idx[..., 1]) * size + idx[..., 2]


def resize_projection(proj, image_hw, feature_hw):
    """(..., 3, 4) projections to image pixels -> to the feature map's: the
    rows of x and y scaled by feature / image, as the public code's
    Camera.update_after_resize scales the intrinsics."""
    sy = feature_hw[0] / image_hw[0]
    sx = feature_hw[1] / image_hw[1]
    return torch.cat([proj[..., :1, :] * sx, proj[..., 1:2, :] * sy,
                      proj[..., 2:, :]], dim=-2)


def unproject(features, proj, coords):
    """Lift the views' features into the cuboid, merging the views by a
    softmax over them.

    features (B, V, C, h, w); proj (B, V, 3, 4) to the feature map's
    pixels; coords (B, D, H, W, 3) -> (B, C, D, H, W). Each voxel centre
    is projected into each view and sampled bilinearly there
    (F.grid_sample, align_corners=True, zeros outside) at
    2 * (u / h - 0.5), 2 * (v / w - 0.5), as the public code normalises;
    a centre at or behind a camera (depth <= 0) reads 0 in that view.
    Then, per voxel and channel, the views' values weighted by their
    softmax over the views."""
    B, V, C, h, w = features.shape
    D, H, W = coords.shape[1:4]
    pts = coords.reshape(B, 1, D * H * W, 3)
    uvw = (torch.einsum("bvij,bvnj->bvni", proj[..., :3], pts)
           + proj[:, :, None, :, 3])
    depth = uvw[..., 2:]
    behind = depth <= 0.0
    uv = uvw[..., :2] / torch.where(depth == 0.0, 1.0, depth)
    grid = torch.stack([2.0 * (uv[..., 0] / h - 0.5),
                        2.0 * (uv[..., 1] / w - 0.5)], dim=-1)
    vol = F.grid_sample(features.reshape(B * V, C, h, w),
                        grid.reshape(B * V, D, H * W, 2),
                        align_corners=True)
    vol = vol.view(B, V, C, D * H * W) * ~behind.view(B, V, 1, D * H * W)
    vol = (vol * torch.softmax(vol, dim=1)).sum(dim=1)
    return vol.view(B, C, D, H, W)


def soft_argmax_3d(logits):
    """(B, D, H, W, J) contiguous logits -> (B, J, 3) expected voxel index
    (d, h, w) under the softmax over the D * H * W voxels, differentiable.

    Two launches of K1 (ops/softargmax.py) on flat views of the one volume:
    (B, D * H, W, J) gives E[w] as its x and E[H * d + h] as its y, and
    (B, D, H * W, J) gives E[d] as its y, so E[h] = E[H * d + h] - H * E[d]
    (exact; what is left is fp32 rounding of the two sums). The backward
    is the sum of the two launches' K2."""
    B, D, H, W, J = logits.shape
    a = soft_argmax_fused(logits.view(B, D * H, W, J))
    b = soft_argmax_fused(logits.view(B, D, H * W, J))
    ed = b[..., 1]
    return torch.stack([ed, a[..., 1] - H * ed, a[..., 0]], dim=-1)
