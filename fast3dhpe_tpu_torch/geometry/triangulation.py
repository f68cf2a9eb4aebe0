"""Multi-view DLT triangulation, batched, in fp32.

Port of fast3dhpe_tpu/geometry/triangulation.py: `pinv_projection`,
`_dlt_system`, `_dehomogenize`, `dlt_triangulate` by all three methods
("jacobi", "svd", "sii"), `sii_triangulate` and `triangulate_closed_form`.
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
    method: "jacobi" (the smallest right singular vector by the batched
    Jacobi SVD, the default), "svd" (torch.linalg.svd, a cross-check) or
    "sii" (shifted inverse iteration, sii_triangulate: another estimator,
    ~1 mm from the DLT under detection noise).
    """
    if method == "sii":
        return sii_triangulate(proj, points)
    A = _dlt_system(proj, points)
    if method == "jacobi":
        homo = smallest_right_singular_vector(A)
    elif method == "svd":
        # 2V >= 4 rows: the reduced SVD keeps all 4 right singular vectors
        _, _, vh = torch.linalg.svd(A, full_matrices=False)
        homo = -vh[..., -1, :]
    else:
        raise ValueError(f"unknown DLT method {method!r}")
    return _dehomogenize(homo)


def sii_triangulate(proj, points, num_iterations: int = 2,
                    generator: torch.Generator = None, shift: float = 1e-6):
    """Shifted-inverse-iteration triangulation, SVD-free
    (triangulation.py:128-178).

    Each column of A is scaled to unit norm first (a diagonal change of
    homogeneous coordinates, undone at the end): on camera-scale rigs the
    raw normal matrix sits at fp32's noise floor, the equilibrated one
    does not. The shift is relative to its trace, 4. The start vector is
    all ones, or uniform draws from `generator` (JAX's `key`), a
    generator on the inputs' device.

    proj: (..., V, 3, 4); points: (..., V, 2). Returns (..., 3).
    """
    A = _dlt_system(proj, points)
    colnorm = torch.linalg.vector_norm(A, dim=-2, keepdim=True)
    D = 1.0 / colnorm.clamp_min(1e-30)
    An = A * D
    M = An.transpose(-1, -2) @ An
    B = M + (4.0 * shift) * torch.eye(4, dtype=M.dtype, device=M.device)
    shape = M.shape[:-2] + (4,)
    if generator is None:
        b = torch.ones(shape, dtype=M.dtype, device=M.device)
    else:
        b = torch.rand(shape, generator=generator, dtype=M.dtype,
                       device=M.device)
    b = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    for _ in range(num_iterations):
        b = torch.linalg.solve(B, b[..., None])[..., 0]
        b = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    return _dehomogenize(-b * D[..., 0, :])


def triangulate_closed_form(P1, P2, pts1, pts2):
    """Two-view triangulation of N points (triangulation.py:181-209): per
    point the rows [y P[2] - P[1] ; P[0] - x P[2]] of both views, and the
    smallest right singular vector of that 4x4 system by the Jacobi SVD.

    P1, P2: (3, 4) or (4, 4) projections (rows 0-2 used); pts1, pts2:
    (N, 2). Returns (N, 3).
    """
    def rows(P, pts):
        P = torch.as_tensor(P, dtype=torch.float32)
        pts = torch.as_tensor(pts, dtype=torch.float32, device=P.device)
        r0 = pts[:, 1:2] * P[2][None, :] - P[1][None, :]
        r1 = P[0][None, :] - pts[:, 0:1] * P[2][None, :]
        return torch.stack([r0, r1], dim=1)

    M = torch.cat([rows(P1, pts1), rows(P2, pts2)], dim=1)
    return _dehomogenize(smallest_right_singular_vector(M))
