"""Heatmap encode and decode. Port of fast3dhpe_tpu/ops/heatmap.py
`soft_argmax`, `hard_argmax` and `render_gaussian_heatmaps`, and of the
closed-form soft-argmax backward (fast3dhpe_tpu/ops/pallas_softargmax.py
`_fused_bwd`)."""

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


def render_gaussian_heatmaps(joints, joints_vis, heatmap_size, image_size,
                             sigma: int = 3):
    """Gaussian target heatmaps and target weights (ops/heatmap.py:65-122),
    with the reference's quirks: the centre is mu = trunc(x / stride +
    0.5), truncated toward zero; the gaussian is written only inside the
    (6 sigma + 1)^2 window around mu; a joint whose window lies wholly
    outside the heatmap gets weight 0 and no gaussian.

    Args:
      joints: (..., J, 2+) joint positions in image pixels.
      joints_vis: (..., J) or (..., J, C) visibility (first column used).
      heatmap_size: (W_hm, H_hm), width first; image_size: (W_img, H_img).
      sigma: in heatmap pixels.
    Returns:
      target (..., H_hm, W_hm, J) fp32 and target_weight (..., J).
    """
    W_hm, H_hm = heatmap_size
    W_img, H_img = image_size
    tmp_size = sigma * 3
    joints = torch.as_tensor(joints, dtype=torch.float32)
    vis = torch.as_tensor(joints_vis, dtype=torch.float32,
                          device=joints.device)
    if vis.dim() == joints.dim():
        vis = vis[..., 0]

    mu_x = torch.trunc(joints[..., 0] / (W_img / W_hm) + 0.5)   # (..., J)
    mu_y = torch.trunc(joints[..., 1] / (H_img / H_hm) + 0.5)
    out_of_bounds = ((mu_x - tmp_size >= W_hm) | (mu_y - tmp_size >= H_hm)
                     | (mu_x + tmp_size + 1 < 0) | (mu_y + tmp_size + 1 < 0))
    weight = torch.where(out_of_bounds, 0.0, vis)

    xs = torch.arange(W_hm, dtype=torch.float32, device=joints.device)
    ys = torch.arange(H_hm, dtype=torch.float32, device=joints.device)
    # built directly as (..., H, W, J)
    dx = xs[:, None] - mu_x[..., None, None, :]             # (..., 1, W, J)
    dy = ys[:, None, None] - mu_y[..., None, None, :]       # (..., H, 1, J)
    g = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
    in_window = (dx.abs() <= tmp_size) & (dy.abs() <= tmp_size)
    g = torch.where(in_window, g, 0.0)
    return g * (weight[..., None, None, :] > 0.5), weight
