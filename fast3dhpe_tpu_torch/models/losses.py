"""Loss functions. Port of fast3dhpe_tpu/models/losses.py (:21-113).

  pred, target: heatmaps (B, J, H, W) or NHWC (B, H, W, J) for the MSE
    losses, or coordinates (B, J, D) for the smooth and MPJPE losses.
  target_weight: (B, J) or (B, J, 1) per-joint weights, multiplied into
    both pred and target, as the reference does.
"""

from __future__ import annotations

import torch


def _apply_weight(pred, target, target_weight):
    if target_weight is None:
        return pred, target
    w = torch.as_tensor(target_weight, device=pred.device)
    # (B, J, 1, ..., 1), broadcast over the trailing dims
    w = w.reshape(w.shape[0], w.shape[1], *([1] * (pred.dim() - 2)))
    return pred * w, target * w


def _as_bj_first(x, layout):
    """(B, J, H, W) as it is, or NHWC (B, H, W, J) moved to it."""
    return x.movedim(-1, 1) if layout == "NHWC" else x


def joints_mse_loss(pred, target, target_weight=None, layout="BJHW"):
    """0.5 * MSE averaged over joints."""
    pred = _as_bj_first(pred, layout)
    target = _as_bj_first(target, layout)
    pred = pred.reshape(pred.shape[0], pred.shape[1], -1)
    target = target.reshape(target.shape[0], target.shape[1], -1)
    pred, target = _apply_weight(pred, target, target_weight)
    return 0.5 * ((pred - target) ** 2).mean()


def joints_mse_smooth_loss(pred, target, target_weight=None,
                           threshold: float = 400.0, layout="BJHW"):
    """Squared error whose values above `threshold` are compressed to
    (d^2)^0.1 * threshold^0.9."""
    pred = _as_bj_first(pred, layout)
    target = _as_bj_first(target, layout)
    pred, target = _apply_weight(pred, target, target_weight)
    diff = (pred - target) ** 2
    compressed = diff.clamp_min(1e-30) ** 0.1 * threshold ** 0.9
    return torch.where(diff > threshold, compressed, diff).mean()


def mpjpe_loss(pred, target, target_weight=None):
    """Mean per-joint position error: sqrt(sum_d diff^2 + 1e-15), averaged
    over batch and joints. pred/target: (B, J, D)."""
    pred, target = _apply_weight(pred, target, target_weight)
    return torch.sqrt(((pred - target) ** 2).sum(-1) + 1e-15).mean()


def make_loss(loss_type: str, use_target_weight: bool, layout="BJHW"):
    """fn(pred, target, target_weight, sample_mask=None) -> scalar.

    sample_mask: optional (B,) 0/1 row validity. Masked rows contribute
    zero residual, and the mean is renormalised to the valid rows by
    B / max(sum(mask), 1).
    """
    def wrap(fn):
        def call(pred, target, target_weight=None, sample_mask=None):
            tw = target_weight if use_target_weight else None
            if sample_mask is None:
                return fn(pred, target, tw)
            m = torch.as_tensor(sample_mask, device=pred.device).float()
            if tw is None:
                tw_m = m[:, None]                       # (B, 1) broadcasts
            else:
                tw_a = torch.as_tensor(tw, device=pred.device)
                tw_m = tw_a * m.reshape((-1,) + (1,) * (tw_a.dim() - 1))
            scale = m.shape[0] / m.sum().clamp_min(1.0)
            return fn(pred, target, tw_m) * scale
        return call

    if loss_type == "JointsMSE":
        return wrap(lambda p, t, w: joints_mse_loss(p, t, w, layout=layout))
    if loss_type == "JointsMSESmooth":
        return wrap(lambda p, t, w: joints_mse_smooth_loss(p, t, w,
                                                           layout=layout))
    if loss_type == "MPJPE":
        return wrap(mpjpe_loss)
    raise NotImplementedError(f"Unknown loss type {loss_type!r}")
