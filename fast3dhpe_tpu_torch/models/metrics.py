"""Evaluation metrics. Port of fast3dhpe_tpu/models/metrics.py (:16-147).
They stay on the device: no host sync."""

from __future__ import annotations

import torch

from ..ops.heatmap import hard_argmax


def pck_counts(output, target, thr: float = 0.05, row_mask=None):
    """Per-joint PCK hits and valid counts, the accumulatable form.

    Args:
      output, target: (B, H, W, J) heatmaps (NHWC).
      row_mask: optional (B,) 0/1 validity; padded rows are excluded.
    Returns:
      hits (J,) fp32, cnt (J,) fp32, pred (B, J, 2).
    """
    pred, _ = hard_argmax(output)
    gt, _ = hard_argmax(target)
    H, W = output.shape[-3], output.shape[-2]
    # [H, W] / 10 applied to (x, y): x is divided by H/10 and y by W/10,
    # the reference's quirk (the same for square heatmaps)
    # made by fills on the device, not from host data: a CUDA graph of a
    # train or eval step captures it
    norm = torch.stack([output.new_full((), H, dtype=torch.float32),
                        output.new_full((), W, dtype=torch.float32)]) / 10.0
    valid = (gt[..., 0] > 1) & (gt[..., 1] > 1)          # (B, J)
    if row_mask is not None:
        valid = valid & (torch.as_tensor(row_mask,
                                         device=output.device) > 0)[:, None]
    d = torch.linalg.vector_norm((pred - gt) / norm, dim=-1)
    hit = (d < thr) & valid
    return hit.sum(0).float(), valid.sum(0).float(), pred


def pck_from_counts(hits, cnt):
    """(avg_acc, per_joint) from accumulated counts: per-joint accuracy is
    -1 where a joint has no valid sample, and the average covers the joints
    that have one."""
    hits, cnt = hits.float(), cnt.float()
    has_valid = cnt > 0
    per_joint = torch.where(has_valid, hits / cnt.clamp_min(1.0), -1.0)
    n_valid = has_valid.sum()
    avg = torch.where(
        n_valid > 0,
        torch.where(has_valid, per_joint, 0.0).sum() / n_valid.clamp_min(1),
        0.0)
    return avg, per_joint


def pck_accuracy(output, target, thr: float = 0.05, row_mask=None):
    """PCK@thr on heatmaps by the argmax decode of prediction and ground
    truth. Returns (avg_acc, per_joint, pred)."""
    hits, cnt, pred = pck_counts(output, target, thr, row_mask)
    avg, per_joint = pck_from_counts(hits, cnt)
    return avg, per_joint, pred


def _weighted(pred_2ds, pred_3d, gt_3d, gt_2d_left, gt_2d_right,
              target_weight):
    pred_l, pred_r = pred_2ds[:, 0], pred_2ds[:, 1]
    gt_l, gt_r = gt_2d_left, gt_2d_right
    if target_weight is not None:
        w = torch.as_tensor(target_weight, device=pred_3d.device)
        if w.dim() == 2:
            w = w[..., None]
        pred_l, pred_r = pred_l * w, pred_r * w
        pred_3d, gt_3d = pred_3d * w, gt_3d * w
        gt_l, gt_r = gt_l * w, gt_r * w
    return pred_l, pred_r, pred_3d, gt_3d, gt_l, gt_r


def _norm(a, b):
    return torch.linalg.vector_norm(a - b, dim=-1)


def calc_mpjpe(pred_2ds, pred_3d, gt_3d, gt_2d_left, gt_2d_right,
               target_weight=None):
    """Mean 2D pixel error (the mean of the views) and 3D MPJPE (mm).

    Predictions and targets are multiplied by target_weight and the norms
    averaged over ALL joints: an invisible joint adds zero error but still
    counts in the denominator, as in the reference.
    """
    pl, pr, p3, g3, gl, gr = _weighted(pred_2ds, pred_3d, gt_3d, gt_2d_left,
                                       gt_2d_right, target_weight)
    return ((_norm(pl, gl).mean() + _norm(pr, gr).mean()) / 2.0,
            _norm(p3, g3).mean())


def per_sample_mpjpe(pred_2ds, pred_3d, gt_3d, gt_2d_left, gt_2d_right,
                     target_weight=None):
    """Per-sample (B,) 2D and 3D errors with calc_mpjpe's weighting."""
    pl, pr, p3, g3, gl, gr = _weighted(pred_2ds, pred_3d, gt_3d, gt_2d_left,
                                       gt_2d_right, target_weight)
    return ((_norm(pl, gl).mean(-1) + _norm(pr, gr).mean(-1)) / 2.0,
            _norm(p3, g3).mean(-1))
