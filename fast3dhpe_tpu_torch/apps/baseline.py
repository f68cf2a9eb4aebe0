"""The naive stereo baseline: PoseResNet on each view, the hard argmax of
its heatmaps, then the DLT. Port of fast3dhpe_tpu/apps/baseline.py.

Both views go through one PoseResNet batch (fp32, unfused); the heatmap
maxima (ops/heatmap.py hard_argmax), scaled to the image, are triangulated
by the Jacobi DLT over all (B, J) joints at once. The coordinates stay
float, where the reference casts them to uint8 (baseline.py:54), which
truncates any coordinate above 255.

    python -m fast3dhpe_tpu_torch.apps.baseline --config_path configs/mads_2d.yaml
"""

from __future__ import annotations

import argparse
import os
from typing import Tuple

import torch

from ..config import load_config
from ..data.stream import LoadMADSData
from ..device import resolve_device
from ..geometry.camera import project_points
from ..geometry.triangulation import dlt_triangulate
from ..models.metrics import per_sample_mpjpe
from ..models.poseresnet import PoseResNet
from ..ops.heatmap import hard_argmax
from ..ops.warp import affine_warp, normalize_imagenet
from ..train.checkpoint import load_variables
from ..utils.logging import setup_logger
from .eval_loop import evaluate_stream, make_cached_eval


class BaselineEstimator:
    """Loads weights/<MODEL.NAME>/latest.pth, else best.pth, as the
    reference baseline does (baseline.py:40-46)."""

    def __init__(self, config, weights_root: str = "weights",
                 device="cuda"):
        self.device = resolve_device(device)
        self.config = config
        path = os.path.join(weights_root, config.MODEL.NAME)
        for cand in ("latest.pth", "latest", "best.pth", "best"):
            if os.path.exists(os.path.join(path, cand)):
                state_dict = load_variables(os.path.join(path, cand))
                break
        else:
            raise FileNotFoundError(f"No checkpoint under {path}")
        model = PoseResNet.from_config(config)
        model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        self.scale = (config.MODEL.IMAGE_SIZE[0]
                      / config.MODEL.EXTRA.HEATMAP_SIZE[0])

    def predict_batch(self, img_l, img_r, proj, trans=None):
        """uint8 frames (B, H, W, 3) x2 + proj (B, 2, 3, 4) -> (pred_2d
        (B, 2, J, 2) image pixels, pred_3d (B, J, 3)) on the device; raw
        frames are cropped on the device first when trans (B, 2, 3) is
        given. The reference's closed-form system of each joint equals the
        DLT system up to a row sign, which leaves its singular vectors
        unchanged."""
        with torch.inference_mode():
            img_l = torch.as_tensor(img_l).to(self.device)
            img_r = torch.as_tensor(img_r).to(self.device)
            if trans is not None:
                size = tuple(self.config.MODEL.IMAGE_SIZE)
                trans = torch.as_tensor(trans).to(self.device, torch.float32)
                img_l = affine_warp(img_l, trans, size)
                img_r = affine_warp(img_r, trans, size)
            B = img_l.shape[0]
            x = torch.cat([normalize_imagenet(img_l),
                           normalize_imagenet(img_r)], dim=0)
            preds, _ = hard_argmax(self.model(x))
            kp = torch.stack([preds[:B], preds[B:]], dim=1) * self.scale
            J = kp.shape[2]
            proj = torch.as_tensor(proj).to(self.device, torch.float32)
            proj_j = proj[:, None].expand(B, J, 2, 3, 4)
            return kp, dlt_triangulate(proj_j, kp.transpose(1, 2))

    def predict_eval(self, img_l, img_r, trans, proj, pose_3d, vis):
        """One batch's per-sample MPJPE2D and MPJPE3D (B,), on the device."""
        pred_2d, pred_3d = self.predict_batch(img_l, img_r, proj, trans)
        with torch.inference_mode():
            proj = torch.as_tensor(proj).to(self.device, torch.float32)
            pose_3d = torch.as_tensor(pose_3d).to(self.device, torch.float32)
            vis = torch.as_tensor(vis).to(self.device, torch.float32)
            return per_sample_mpjpe(pred_2d, pred_3d, pose_3d,
                                    project_points(pose_3d, proj[:, 0]),
                                    project_points(pose_3d, proj[:, 1]), vis)

    def evaluate_movement(self, stream, batch_size: int = 32,
                          device_cache_bytes: int = 0
                          ) -> Tuple[float, float]:
        """Sequence-average MPJPE2D (px) and MPJPE3D (mm), per frame, by
        apps/eval_loop.py evaluate_stream."""
        if stream.device != self.device:
            raise ValueError(f"the stream is on {stream.device}, the "
                             f"estimator on {self.device}")
        return evaluate_stream(self.predict_eval,
                               make_cached_eval(self.predict_eval), stream,
                               batch_size, device_cache_bytes)

    def render_frames(self, stream, max_frames: int,
                      out_jpg: str = "test.jpg", batch_size: int = 32):
        """Reference-style per-frame visualisation frames (utils/render.py)
        [ref: baseline.py:85-101]."""
        from ..utils.render import render_prediction_frames
        return render_prediction_frames(self.predict_batch, stream,
                                        max_frames, out_jpg, batch_size)


def main(argv=None):
    """Returns (MPJPE2D, MPJPE3D)."""
    parser = argparse.ArgumentParser(
        description="Evaluate the PoseResNet + DLT baseline on a MADS "
                    "movement.")
    parser.add_argument("--config_path", type=str,
                        default="configs/mads_2d.yaml")
    parser.add_argument("--movement", type=str, default="HipHop")
    parser.add_argument("--save_frames", type=int, default=None,
                        help="Number of frames to render into a gif")
    parser.add_argument("--data_path", type=str,
                        default="data/MADS_extract/valid")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--device_cache_mb", type=int, default=2048,
                        help="device memory budget for the movement's "
                             "frames (0 disables)")
    parser.add_argument("--weights_root", type=str, default="weights")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; an error without a card) or "
                             "cpu")
    args = parser.parse_args(argv)

    logger = setup_logger()
    config = load_config(args.config_path)
    estimator = BaselineEstimator(config, weights_root=args.weights_root,
                                  device=args.device)
    stream = LoadMADSData(args.data_path, config.MODEL.IMAGE_SIZE,
                          args.movement, device=estimator.device)
    logger.info("%d frames in %s", len(stream), args.movement)
    e2, e3 = estimator.evaluate_movement(
        stream, args.batch_size,
        device_cache_bytes=args.device_cache_mb << 20)
    print("MPJPE2D: ", e2)
    print("MPJPE3D: ", e3)

    if args.save_frames:
        from ..utils.visualize import save_gif
        frames = estimator.render_frames(stream, args.save_frames)
        save_gif(frames, f"{args.movement}.gif")
        logger.info("Wrote %s.gif (%d frames)", args.movement, len(frames))
    return e2, e3


if __name__ == "__main__":
    main()
