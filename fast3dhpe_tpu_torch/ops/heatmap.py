"""Heatmap decode. Port of fast3dhpe_tpu/ops/heatmap.py `soft_argmax` and
`hard_argmax`, and of the closed-form soft-argmax backward
(fast3dhpe_tpu/ops/pallas_softargmax.py `_fused_bwd`)."""

from __future__ import annotations

import torch


def _softmax_rows(heatmaps):
    """(..., H, W, J) logits -> fp32 probabilities over H*W, max detached
    (stop_gradient in the JAX version)."""
    h = heatmaps.float()
    *lead, H, W, J = h.shape
    flat = h.reshape(*lead, H * W, J)
    flat = flat - flat.amax(dim=-2, keepdim=True).detach()
    p = flat.exp()
    return (p / p.sum(dim=-2, keepdim=True)).reshape(*lead, H, W, J)


def soft_argmax(heatmaps):
    """Spatial softmax + centre of mass, in fp32 whatever the input type.

    The plain version of the soft-argmax kernel (ops/softargmax.py), and
    differentiable by autograd.

    Args:
      heatmaps: (..., H, W, J) raw logits, any strides.
    Returns:
      (..., J, 2) expected (x, y) in heatmap pixels: x is the column, y the
      row.
    """
    p = _softmax_rows(heatmaps)
    H, W = p.shape[-3], p.shape[-2]
    xs = torch.arange(W, dtype=p.dtype, device=p.device)
    ys = torch.arange(H, dtype=p.dtype, device=p.device)
    cx = torch.einsum("...hwj,w->...j", p, xs)
    cy = torch.einsum("...hwj,h->...j", p, ys)
    return torch.stack([cx, cy], dim=-1)


def soft_argmax_bwd(heatmaps, g):
    """The closed-form gradient of soft_argmax: the plain version of the
    soft-argmax backward kernel (ops/softargmax.py).

    dL/dh = p * (gx * (x - cx) + gy * (y - cy)), with p, cx and cy
    recomputed from the logits, in fp32.

    Args:
      heatmaps: (N, H, W, J) logits, fp32 or bf16, any strides.
      g: (N, J, 2) cotangent of the (x, y) output.
    Returns:
      (N, H, W, J) in the logits' dtype (the fp32 gradient rounded once,
      as the JAX model's cast to fp32 rounds it in its backward).
    """
    p = _softmax_rows(heatmaps)
    H, W = p.shape[-3], p.shape[-2]
    xs = torch.arange(W, dtype=p.dtype, device=p.device)[None, None, :, None]
    ys = torch.arange(H, dtype=p.dtype, device=p.device)[None, :, None, None]
    cx = (xs * p).sum(dim=(1, 2), keepdim=True)
    cy = (ys * p).sum(dim=(1, 2), keepdim=True)
    g = g.float()
    gx = g[..., 0][:, None, None, :]
    gy = g[..., 1][:, None, None, :]
    return (p * (gx * (xs - cx) + gy * (ys - cy))).to(heatmaps.dtype)


def hard_argmax(heatmaps):
    """Argmax heatmap decode (ops/heatmap.py:43-62).

    Args:
      heatmaps: (..., H, W, J).
    Returns:
      preds: (..., J, 2) (x, y) of the first maximum, zeroed where the
        maximum is <= 0; maxvals: (..., J).
    """
    *lead, H, W, J = heatmaps.shape
    flat = heatmaps.reshape(*lead, H * W, J)
    maxvals = flat.amax(dim=-2)
    idx = flat.argmax(dim=-2)                      # the first maximum
    x = (idx % W).float()
    y = torch.floor(idx.float() / W)
    preds = torch.stack([x, y], dim=-1)
    return preds * (maxvals > 0.0).float()[..., None], maxvals
