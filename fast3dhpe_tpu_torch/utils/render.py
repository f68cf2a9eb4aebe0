"""The per-frame visualisation flow of the inference and baseline apps.
Port of fast3dhpe_tpu/utils/render.py: predictions run in batches through
the estimator's `predict_batch`; each frame's 2D overlay (cv2) and 3D plot
(matplotlib) are drawn on the host.
"""

from __future__ import annotations

import numpy as np

from ..geometry.camera import project_points_np
from .visualize import plot_pose_2d, plot_pose_3d


def render_prediction_frames(predict_batch, stream, max_frames: int,
                             out_jpg: str = "test.jpg",
                             batch_size: int = 32):
    """Reference-style frames: the 2D overlay of both views above the 3D
    plot, RGB uint8, for the first max_frames frames of the stream
    (data/stream.py LoadMADSData). The last frame is also written to
    out_jpg, as the reference's progressive test.jpg.

    predict_batch: callable(img_l, img_r, proj) -> (pred_2d (B, 2, J, 2),
    pred_3d (B, J, 3)), CDRNetInferencer's or BaselineEstimator's.
    """
    import cv2
    frames = []
    for batch in stream.batches(batch_size):
        if len(frames) >= max_frames:
            break
        pred_2d, pred_3d = predict_batch(
            batch["img_l"], batch["img_r"], batch["proj"])
        pred_2d = pred_2d.float().cpu().numpy()
        pred_3d = pred_3d.float().cpu().numpy()
        imgs_l = batch["img_l"].cpu().numpy()
        imgs_r = batch["img_r"].cpu().numpy()
        P = batch["proj"]
        poses = np.nan_to_num(batch["pose_3d"]).astype(np.float32)
        gts_l = project_points_np(poses, P[:, 0])
        gts_r = project_points_np(poses, P[:, 1])
        for i in range(batch["n_valid"]):
            if len(frames) >= max_frames:
                break
            img_2d = plot_pose_2d((gts_l[i], gts_r[i]),
                                  (pred_2d[i, 0], pred_2d[i, 1]),
                                  (imgs_l[i].copy(), imgs_r[i].copy()))
            img_2d = cv2.cvtColor(img_2d, cv2.COLOR_BGR2RGB)
            img_3d = plot_pose_3d(poses[i], pred_3d[i])
            ratio = img_2d.shape[1] / img_3d.shape[1]
            img_3d = cv2.resize(img_3d,
                                (int(img_3d.shape[1] * ratio),
                                 int(img_3d.shape[0] * ratio)))
            frames.append(np.vstack((img_2d, img_3d)))
    if frames:
        cv2.imwrite(out_jpg, cv2.cvtColor(frames[-1], cv2.COLOR_RGB2BGR))
    return frames
