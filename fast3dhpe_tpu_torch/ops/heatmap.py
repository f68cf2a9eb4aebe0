"""Heatmap decode. Port of fast3dhpe_tpu/ops/heatmap.py `soft_argmax`."""

from __future__ import annotations

import torch


def soft_argmax(heatmaps):
    """Spatial softmax + centre of mass, in fp32 whatever the input type.

    The plain version of the soft-argmax kernel (ops/softargmax.py).

    Args:
      heatmaps: (..., H, W, J) raw logits, any strides.
    Returns:
      (..., J, 2) expected (x, y) in heatmap pixels: x is the column, y the
      row.
    """
    h = heatmaps.float()
    *lead, H, W, J = h.shape
    flat = h.reshape(*lead, H * W, J)
    flat = flat - flat.amax(dim=-2, keepdim=True)
    p = flat.exp()
    p = (p / p.sum(dim=-2, keepdim=True)).reshape(*lead, H, W, J)
    xs = torch.arange(W, dtype=p.dtype, device=p.device)
    ys = torch.arange(H, dtype=p.dtype, device=p.device)
    cx = torch.einsum("...hwj,w->...j", p, xs)
    cy = torch.einsum("...hwj,h->...j", p, ys)
    return torch.stack([cx, cy], dim=-1)
