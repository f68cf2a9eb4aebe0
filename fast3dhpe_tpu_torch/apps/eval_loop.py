"""Movement evaluation shared by the apps. Port of
fast3dhpe_tpu/apps/eval_loop.py (:23-90).

A movement is evaluated batch by batch: crop, forward, ground-truth
projection and per-sample MPJPE, with the masked sums kept on the device
so that the loop fetches nothing until the movement ends.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def make_cached_eval(predict_eval):
    """Wrap `predict_eval(img_l, img_r, trans, proj, pose_3d, vis) -> (e2,
    e3)` so that the frames are gathered by row from a device frame cache
    (data/stream.py build_device_cache) first."""

    def predict_eval_cached(frames, idx_l, idx_r, trans, proj, pose_3d,
                            vis):
        dev = frames.device
        img_l = frames.index_select(0, torch.as_tensor(
            idx_l, dtype=torch.long, device=dev))
        img_r = frames.index_select(0, torch.as_tensor(
            idx_r, dtype=torch.long, device=dev))
        return predict_eval(img_l, img_r, trans, proj, pose_3d, vis)

    return predict_eval_cached


def accum_eval(tot2, tot3, n, e2, e3, k):
    """Add the first k rows of the per-sample errors e2, e3 (B,) to the
    device sums; padded rows (>= k) never count."""
    m = (torch.arange(e2.shape[0], device=e2.device) < k).to(e2.dtype)
    return tot2 + (e2 * m).sum(), tot3 + (e3 * m).sum(), n + k


def ground_truth(pose_3d):
    """(B, J, 3) float64 pose with NaN joints -> (fp32 pose with 0 for NaN,
    (B, J) fp32 visibility: all three coordinates finite)."""
    vis = np.logical_and.reduce(~np.isnan(pose_3d), axis=-1)
    return (np.nan_to_num(pose_3d).astype(np.float32),
            vis.astype(np.float32))


def evaluate_stream(predict_eval, predict_eval_cached, stream,
                    batch_size: int,
                    device_cache_bytes: int = 0) -> Tuple[float, float]:
    """Sequence-average MPJPE2D (px) and MPJPE3D (mm), averaged per frame,
    over stream.batches(device_warp=True): index batches of a device cache
    (full or partial), raw frames with their affines, or host crops (the
    identity affine then). One fetch from the device, at the end."""
    tot2 = tot3 = n = torch.zeros((), dtype=torch.float32,
                                  device=stream.device)
    identity = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32)
    for batch in stream.batches(batch_size, device_warp=True,
                                device_cache_bytes=device_cache_bytes):
        pose_3d, vis = ground_truth(batch["pose_3d"])
        if "frames" in batch:
            e2, e3 = predict_eval_cached(
                batch["frames"], batch["idx_l"], batch["idx_r"],
                batch["trans"], batch["proj"], pose_3d, vis)
        else:
            trans = batch.get("trans")
            if trans is None:
                trans = np.broadcast_to(identity, (len(pose_3d), 2, 3))
            e2, e3 = predict_eval(batch["img_l"], batch["img_r"], trans,
                                  batch["proj"], pose_3d, vis)
        tot2, tot3, n = accum_eval(tot2, tot3, n, e2, e3, batch["n_valid"])
    tot2, tot3, n = torch.stack([tot2, tot3, n]).tolist()
    return tot2 / max(n, 1.0), tot3 / max(n, 1.0)
