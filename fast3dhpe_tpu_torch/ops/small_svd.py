"""Batched one-sided Jacobi SVD for tiny matrices, in fp32.

Port of fast3dhpe_tpu/ops/small_svd.py. Every step is a batched tensor op
on whole columns, and columns are replaced, never written in place, so
autograd can differentiate the result unchanged.
"""

from __future__ import annotations

import torch

SWEEPS = 10


def _rotate(wp, wq, vp, vq):
    """One Jacobi rotation orthogonalising columns wp, wq (small_svd.py:26-67).

    theta = 0.5 * atan2(-2 gamma, alpha - beta); an already diagonal pair,
    where both arguments vanish, gets the zero rotation.
    """
    alpha = (wp * wp).sum(-1)
    beta = (wq * wq).sum(-1)
    gamma = (wp * wq).sum(-1)
    denom = alpha - beta
    degenerate = (gamma * gamma + denom * denom) < 1e-30
    theta = torch.where(
        degenerate, 0.0,
        0.5 * torch.atan2(-2.0 * gamma, torch.where(degenerate, 1.0, denom)))
    c = torch.cos(theta)[..., None]
    s = torch.sin(theta)[..., None]
    return c * wp - s * wq, s * wp + c * wq, c * vp - s * vq, s * vp + c * vq


def jacobi_svd(A, sweeps: int = SWEEPS):
    """One-sided Jacobi SVD of (..., m, n) matrices, m >= n, n small.

    Returns U (..., m, n), S (..., n) descending, V (..., n, n) (columns).
    """
    A = A.float()
    n = A.shape[-1]
    # normalise the overall scale for fp32 headroom (P entries reach ~1e6)
    scale = A.abs().amax(dim=(-2, -1), keepdim=True)
    scale = torch.where(scale == 0.0, 1.0, scale)
    w = list((A / scale).unbind(-1))
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    v = [eye[:, j].expand(A.shape[:-2] + (n,)) for j in range(n)]
    for _ in range(sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                w[p], w[q], v[p], v[q] = _rotate(w[p], w[q], v[p], v[q])
    W = torch.stack(w, dim=-1)
    V = torch.stack(v, dim=-1)
    # sqrt(sum + tiny): the norm's gradient at a zero column would be NaN
    S = torch.sqrt((W * W).sum(-2) + 1e-30)
    # descending; a stable sort, as jnp.argsort is, so ties keep column order
    order = torch.argsort(-S, dim=-1, stable=True)
    S_sorted = torch.gather(S, -1, order)
    cols = order[..., None, :]
    V_sorted = torch.gather(V, -1, cols.expand(V.shape))
    W_sorted = torch.gather(W, -1, cols.expand(W.shape))
    S_safe = torch.where(S_sorted == 0.0, 1.0, S_sorted)
    U = W_sorted / S_safe[..., None, :]
    return U, S_sorted * scale[..., 0], V_sorted


def smallest_right_singular_vector(A):
    """v_min of (..., m, n): the DLT solution vector."""
    return jacobi_svd(A)[2][..., :, -1]


def pinv_small(A):
    """Pseudo-inverse of small (..., m, n) matrices, keeping every singular
    value (rtol=0, as small_svd.pinv_small: projection matrices span
    singular values an fp32 default cutoff would drop)."""
    wide = A.shape[-2] < A.shape[-1]
    if wide:                       # pinv(A) = pinv(A^T)^T
        A = A.transpose(-1, -2)
    U, S, V = jacobi_svd(A)
    S_inv = torch.where(S == 0.0, 0.0, 1.0 / S)
    out = torch.einsum("...ij,...j,...kj->...ik", V, S_inv, U)
    return out.transpose(-1, -2) if wide else out
