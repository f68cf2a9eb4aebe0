"""Multi-view DLT triangulation, batched, in fp32.

Port of fast3dhpe_tpu/geometry/triangulation.py: `pinv_projection`,
`_dlt_system`, `_dehomogenize` and `dlt_triangulate(method="jacobi")`.
"""

from __future__ import annotations

import torch

from ..ops.small_svd import pinv_small, smallest_right_singular_vector


def pinv_projection(P):
    """Pseudo-inverse of (..., 3, 4) projection matrices -> (..., 4, 3),
    by the Jacobi SVD with every singular value kept."""
    return pinv_small(P.float())


def _dlt_system(proj, points):
    """The DLT system A (..., 2V, 4): per view v the rows
    [y_v P_v[2] - P_v[1] ; x_v P_v[2] - P_v[0]], in the reference's order
    and signs (triangulation.py:53-68).

    proj: (..., V, 3, 4); points: (..., V, 2).
    """
    proj = proj.float()
    points = points.float()
    A = proj[..., 2:3, :] * points[..., :, None] - proj[..., :2, :]
    return A.reshape(A.shape[:-3] + (-1, 4))


def _dehomogenize(v, eps: float = 1e-9):
    """(..., 4) -> (..., 3), with |w| floored at eps: an untrained stereo
    net triangulates at infinity (w -> 0), and the floor keeps that finite."""
    w = v[..., 3:4]
    w_safe = torch.where(w.abs() < eps,
                         torch.where(w < 0, -eps, eps), w)
    return v[..., :3] / w_safe


def dlt_triangulate(proj, points, method: str = "jacobi"):
    """DLT triangulation batched over all leading axes.

    proj: (..., V, 3, 4); points: (..., V, 2). Returns (..., 3).
    Only "jacobi" (the smallest right singular vector by the batched Jacobi
    SVD) is ported yet.
    """
    if method in ("svd", "sii"):
        raise NotImplementedError(
            f"dlt_triangulate(method={method!r}) is not ported yet; "
            f"use 'jacobi'")
    if method != "jacobi":
        raise ValueError(f"unknown DLT method {method!r}")
    return _dehomogenize(
        smallest_right_singular_vector(_dlt_system(proj, points)))
