"""Camera projection math. Port of fast3dhpe_tpu/geometry/camera.py
(:13-121): batched over any leading axes, fp32, on the inputs' device;
`project_points_np` is the numpy twin for host loops."""

from __future__ import annotations

import numpy as np
import torch


def _f32(x, device=None):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _apply(M, points):
    """(..., I, 3) matrices applied to (..., N, 3) points -> (..., N, I),
    summed over j = 0, 1, 2 in that order by fused multiply-adds, as XLA's
    CPU dot sums: the host index builders (data/mads.py) then project bit
    for bit as the JAX package does."""
    Mt = M.transpose(-1, -2)[..., None, :, :]               # (..., 1, 3, I)
    acc = points[..., 0:1] * Mt[..., 0, :]
    for j in (1, 2):
        acc = torch.addcmul(acc, points[..., j:j + 1], Mt[..., j, :])
    return acc


def world_to_camera(points, R, T):
    """(..., N, 3) world points -> camera frame, with R (..., 3, 3) and
    T (..., 3, 1)."""
    points = _f32(points)
    R, T = _f32(R, points.device), _f32(T, points.device)
    return _apply(R, points) + T.transpose(-1, -2)


def camera_to_image(points, K):
    """Camera frame -> (..., N, 3): pixel x, y, and the depth kept in the
    third column."""
    points = _f32(points)
    p = _apply(_f32(K, points.device), points)
    return torch.cat([p[..., :2] / p[..., 2:3], p[..., 2:3]], dim=-1)


def get_projection_matrix(K, R, T):
    """P = [K [R|T]; 0 0 0 1], (..., 4, 4)."""
    K = _f32(K)
    R, T = _f32(R, K.device), _f32(T, K.device)
    P3 = torch.einsum("...ij,...jk->...ik", K, torch.cat([R, T], dim=-1))
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=K.device).expand(
        P3.shape[:-2] + (1, 4))
    return torch.cat([P3, bottom], dim=-2)


def project_points_np(points_3d, P):
    """numpy twin of project_points: (..., N, 3) x (..., 3 or 4, 4) ->
    (..., N, 2), fp32."""
    pts = np.asarray(points_3d, np.float32)
    P3 = np.asarray(P, np.float32)[..., :3, :]
    h = np.concatenate([pts, np.ones_like(pts[..., :1])], axis=-1)
    uvw = np.einsum("...ij,...nj->...ni", P3, h)
    with np.errstate(divide="ignore", invalid="ignore"):
        return uvw[..., :2] / uvw[..., 2:3]


def project_3d_to_2d(pose_3d, K, R, T):
    """World 3D -> pixel coordinates and depth, (..., N, 3)."""
    return camera_to_image(world_to_camera(pose_3d, R, T), K)


def project_points(points_3d, P):
    """Project (..., N, 3) world points through the first 3 rows of a
    (..., 3, 4) or (..., 4, 4) projection matrix -> (..., N, 2) pixels."""
    points_3d = _f32(points_3d)
    P = _f32(P, points_3d.device)[..., :3, :]
    homo = torch.cat([points_3d, torch.ones_like(points_3d[..., :1])], -1)
    proj = torch.einsum("...ij,...nj->...ni", P, homo)
    return proj[..., :2] / proj[..., 2:3]


def rodrigues(rvec):
    """(..., 3) rotation vectors -> (..., 3, 3) rotation matrices, by the
    closed form; the identity where the angle is below 1e-12."""
    rvec = _f32(rvec)
    if rvec.shape[-1] != 3:
        raise ValueError(f"rvec must have trailing dim 3, got "
                         f"{tuple(rvec.shape)}")
    theta = torch.linalg.vector_norm(rvec, dim=-1, keepdim=True)
    eps = 1e-12
    k = rvec / (theta + eps)
    zeros = torch.zeros_like(k[..., 0])
    K = torch.stack([
        torch.stack([zeros, -k[..., 2], k[..., 1]], dim=-1),
        torch.stack([k[..., 2], zeros, -k[..., 0]], dim=-1),
        torch.stack([-k[..., 1], k[..., 0], zeros], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, device=rvec.device).expand(K.shape)
    t = theta[..., None]
    R = eye + torch.sin(t) * K + (1.0 - torch.cos(t)) * (K @ K)
    return torch.where(t < eps, eye, R)
