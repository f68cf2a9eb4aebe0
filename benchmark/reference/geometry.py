"""Plain references of the stereo geometry: the pseudo-inverse of the
projections and the DLT triangulation, in float64 through torch.linalg,
returned in fp32; and the projection of world points.

DLT_DTYPE is the precision the DLT's system and SVD are computed in. A
witness sets it to fp32 to read how far rounding alone moves what
depends on the DLT (PERF.md)."""

from __future__ import annotations

import torch

DLT_DTYPE = torch.float64


def pinv(P):
    """(..., 3, 4) -> (..., 4, 3), every singular value kept."""
    return torch.linalg.pinv(P.double(), rtol=0.0).float()


def project(points, P):
    """(..., N, 3) world points through (..., 3 or 4, 4) -> (..., N, 2), in
    the points' dtype."""
    P = P[..., :3, :].to(points.dtype)
    h = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    uvw = torch.einsum("...ij,...nj->...ni", P, h)
    return uvw[..., :2] / uvw[..., 2:3]


def _dlt_system(proj, kp, dtype=torch.float64):
    """The 2V x 4 system of each joint, (B, J, 2V, 4), in dtype."""
    P = proj.to(dtype)[:, None]                             # (B, 1, V, 3, 4)
    pts = kp.to(dtype).transpose(1, 2)                      # (B, J, V, 2)
    A = P[..., 2:3, :] * pts[..., :, None] - P[..., :2, :]  # (B, J, V, 2, 4)
    return A.flatten(-3, -2)


def dlt_residual_gap(proj, kp, points):
    """How far 3D points (B, J, 3) are from solving the DLT of kp: for each
    joint, (|A h| - s_min) / s_max with h = (point, 1) normalised, s the
    singular values of its system A. It is 0 for the DLT's own solution,
    and it measures the fit, not the position: a point that the rays fix
    badly (nearly parallel rays, a point at infinity) still reads small
    when it solves the system."""
    A = _dlt_system(proj, kp)
    s = torch.linalg.svdvals(A)
    h = torch.cat([points.double(), torch.ones_like(points[..., :1],
                                                    dtype=torch.float64)], -1)
    h = h / torch.linalg.vector_norm(h, dim=-1, keepdim=True)
    r = torch.linalg.vector_norm((A @ h[..., None])[..., 0], dim=-1)
    return (r - s[..., -1]) / s[..., 0]


def dlt_triangulate(proj, kp):
    """proj (B, V, 3, 4); kp (B, V, J, 2) -> (B, J, 3): for each joint the
    right singular vector of the smallest singular value of the 2V x 4
    system [y P[2] - P[1]; x P[2] - P[0]] of its views, in DLT_DTYPE,
    dehomogenised with |w| floored at 1e-9."""
    A = _dlt_system(proj, kp, DLT_DTYPE)
    v = torch.linalg.svd(A, full_matrices=False)[2][..., -1, :]
    w = v[..., 3:4]
    w = torch.where(w.abs() < 1e-9, torch.where(w < 0, -1e-9, 1e-9), w)
    return (v[..., :3] / w).float()
