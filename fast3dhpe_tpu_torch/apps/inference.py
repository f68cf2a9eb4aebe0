"""CDRNet stereo inference. Port of fast3dhpe_tpu/apps/inference.py:
`CDRNetInferencer` (:33-249), weights in, stereo batches of uint8 frames
to pred_2d / pred_3d out, a movement's sequence MPJPE and its rendered
frames; and the app (`main`, :252-347), which prints each movement's
MPJPE2D and MPJPE3D and, with --save_frames N, writes <movement>.gif and
test.jpg.

    python -m fast3dhpe_tpu_torch.apps.inference --bf16 --fused_inference \
        --config_path configs/mads_3d.yaml --movement all
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import load_config
from ..data.stream import LoadMADSData
from ..device import resolve_device
from ..geometry.camera import project_points
from ..models.cdrnet import CDRNet
from ..models.metrics import per_sample_mpjpe
from ..ops.warp import affine_warp, normalize_imagenet
from ..train.checkpoint import load_variables
from ..utils.logging import setup_logger
from .eval_loop import accum_eval, evaluate_stream, ground_truth, \
    make_cached_eval


class CDRNetInferencer:
    """Loads weights/<MODEL.NAME>/best.pth (or takes a state dict) and
    predicts stereo batches on one device."""

    def __init__(self, config, weights_root: str = "weights",
                 dtype=torch.float32, fused_inference: bool = False,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 device="cuda", int8: bool = False):
        if int8:
            raise NotImplementedError(
                "int8 serving is A12, slice 6 (int8, export, multi-GPU) of "
                "the port")
        self.device = resolve_device(device)
        self.config = config
        if state_dict is None:
            state_dict = load_variables(
                os.path.join(weights_root, config.MODEL.NAME))
        model = CDRNet.from_config(config, dtype=dtype,
                                   fused_inference=fused_inference)
        model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()

    def predict_batch(self, img_l, img_r, proj, trans=None):
        """uint8 frames (B, H, W, 3) x2 + proj (B, 2, 3, 4) ->
        (pred_2d (B, 2, J, 2), pred_3d (B, J, 3)), on the device.

        With trans (B, 2, 3), the frames are raw (uncropped) and are warped
        on the device to MODEL.IMAGE_SIZE first (ops/warp.py affine_warp,
        as the JAX app's `_predict_raw`); proj is then the cropped view's.
        """
        with torch.inference_mode():
            img_l = torch.as_tensor(img_l).to(self.device, non_blocking=True)
            img_r = torch.as_tensor(img_r).to(self.device, non_blocking=True)
            proj = torch.as_tensor(proj).to(self.device, torch.float32)
            if trans is not None:
                size = tuple(self.config.MODEL.IMAGE_SIZE)
                trans = torch.as_tensor(trans).to(self.device, torch.float32)
                img_l = affine_warp(img_l, trans, size)
                img_r = affine_warp(img_r, trans, size)
            imgs = torch.stack([normalize_imagenet(img_l),
                                normalize_imagenet(img_r)], dim=1)
            return self.model(imgs, proj)

    def eval_errors(self, pred_2d, pred_3d, proj, pose_3d, vis):
        """Per-sample (B,) MPJPE2D and MPJPE3D of predictions against the
        ground truth pose_3d (B, J, 3), projected through the cropped
        views' proj (B, 2, 3, 4); vis (B, J) weights the joints."""
        proj = torch.as_tensor(proj, dtype=torch.float32, device=self.device)
        pose_3d = torch.as_tensor(pose_3d, dtype=torch.float32,
                                  device=self.device)
        vis = torch.as_tensor(vis, dtype=torch.float32, device=self.device)
        return per_sample_mpjpe(pred_2d, pred_3d, pose_3d,
                                project_points(pose_3d, proj[:, 0]),
                                project_points(pose_3d, proj[:, 1]), vis)

    def predict_eval(self, img_l, img_r, trans, proj, pose_3d, vis):
        """One batch's evaluation on the device: crop, forward, ground-truth
        projection and per-sample errors (the JAX app's _predict_eval)."""
        with torch.inference_mode():
            pred_2d, pred_3d = self.predict_batch(img_l, img_r, proj,
                                                  trans=trans)
            return self.eval_errors(pred_2d, pred_3d, proj, pose_3d, vis)

    def evaluate_movement(self, stream, batch_size: int = 32,
                          device_cache_bytes: int = 0
                          ) -> Tuple[float, float]:
        """Sequence-average MPJPE2D (px) and MPJPE3D (mm) of a movement
        (data/stream.py LoadMADSData on this inferencer's device), averaged
        per frame. The sums stay on the device and are fetched once.

        With device_cache_bytes > 0 the movement is held on the device;
        when it fits whole, its batches' metadata is stacked and copied to
        the device once, and one loop gathers and evaluates each batch.
        JAX pads that loop's batch count to a multiple of 8 so that its
        lax.scan compiles once across movements; an eager loop compiles
        nothing, so the port runs the batches as they are. Otherwise
        (partial cache, no cache) the batches stream (evaluate_stream)."""
        if stream.device != self.device:
            raise ValueError(f"the stream is on {stream.device}, the "
                             f"inferencer on {self.device}")
        predict_cached = make_cached_eval(self.predict_eval)
        if device_cache_bytes:
            cache = stream.build_device_cache(device_cache_bytes)
            if cache is not None and not cache.partial:
                batches = list(stream.cached_batches(batch_size, cache))
                pose_3d, vis = ground_truth(np.stack([b["pose_3d"]
                                                      for b in batches]))
                xs = {k: torch.as_tensor(np.stack([b[k] for b in batches]),
                                         device=self.device)
                      for k in ("idx_l", "idx_r", "trans", "proj")}
                pose_3d = torch.as_tensor(pose_3d, device=self.device)
                vis = torch.as_tensor(vis, device=self.device)
                tot2 = tot3 = n = torch.zeros((), device=self.device)
                for i, b in enumerate(batches):
                    e2, e3 = predict_cached(
                        cache.frames, xs["idx_l"][i], xs["idx_r"][i],
                        xs["trans"][i], xs["proj"][i], pose_3d[i], vis[i])
                    tot2, tot3, n = accum_eval(tot2, tot3, n, e2, e3,
                                               b["n_valid"])
                tot2, tot3, n = torch.stack([tot2, tot3, n]).tolist()
                return tot2 / max(n, 1.0), tot3 / max(n, 1.0)
        return evaluate_stream(self.predict_eval, predict_cached, stream,
                               batch_size, device_cache_bytes)

    def render_frames(self, stream, max_frames: int,
                      out_jpg: str = "test.jpg", batch_size: int = 32):
        """Reference-style per-frame visualisation frames (RGB arrays) of
        the stream's first max_frames frames; the last is written to
        out_jpg (utils/render.py)."""
        from ..utils.render import render_prediction_frames
        return render_prediction_frames(self.predict_batch, stream,
                                        max_frames, out_jpg, batch_size)


def main(argv=None):
    """Returns {movement: (MPJPE2D, MPJPE3D)}."""
    parser = argparse.ArgumentParser(
        description="Evaluate CDRNet on MADS movements.")
    parser.add_argument("--config_path", type=str,
                        default="configs/mads_3d.yaml")
    parser.add_argument("--movement", type=str, default="HipHop",
                        help="The movement to evaluate, or 'all' for every "
                             "movement in --data_path")
    parser.add_argument("--save_frames", type=int, default=None,
                        help="Number of frames to render into a gif")
    parser.add_argument("--data_path", type=str,
                        default="data/MADS_extract/valid")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--device_cache_mb", type=int, default=2048,
                        help="device memory budget for the movement's "
                             "frames (0 disables; a movement over it is "
                             "partly held or streamed)")
    parser.add_argument("--weights_root", type=str, default="weights")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; an error without a card) or "
                             "cpu")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute (fp32 params)")
    parser.add_argument("--fused_inference", action="store_true",
                        help="run the fused-bottleneck kernel (K3) in the "
                             "encoder blocks it covers (requires --bf16)")
    parser.add_argument("--int8", action="store_true",
                        help="int8 serving: not ported yet (A12), raises")
    parser.add_argument("--int8_pack", type=str, default=None,
                        help="int8 pack: not ported yet (A12), raises")
    parser.add_argument("--calib_batches", type=int, default=8,
                        help="int8 calibration batches (A12)")
    args = parser.parse_args(argv)
    if args.fused_inference and not args.bf16:
        parser.error("--fused_inference requires --bf16 (K3 runs on "
                     "bfloat16 activations only; without it every block "
                     "would run the plain path)")
    if args.int8 or args.int8_pack:
        raise NotImplementedError(
            "--int8 / --int8_pack: int8 serving is A12, slice 6 of the port")

    logger = setup_logger()
    config = load_config(args.config_path)
    if args.movement == "all":
        movements = sorted(os.path.basename(p) for p in
                           glob.glob(os.path.join(args.data_path, "*"))
                           if os.path.isdir(p))
    else:
        movements = [args.movement]
    inferencer = CDRNetInferencer(
        config, weights_root=args.weights_root,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        fused_inference=args.fused_inference, device=args.device)

    results = {}
    tot2 = tot3 = total_frames = 0.0
    for movement in movements:
        stream = LoadMADSData(args.data_path, config.MODEL.IMAGE_SIZE,
                              movement, device=inferencer.device)
        logger.info("%d frames in %s", len(stream), movement)
        e2, e3 = inferencer.evaluate_movement(
            stream, args.batch_size,
            device_cache_bytes=args.device_cache_mb << 20)
        print(f"[{movement}] MPJPE2D: ", e2)
        print(f"[{movement}] MPJPE3D: ", e3)
        results[movement] = (e2, e3)
        tot2 += e2 * len(stream)
        tot3 += e3 * len(stream)
        total_frames += len(stream)

        if args.save_frames:
            from ..utils.visualize import save_gif
            frames = inferencer.render_frames(stream, args.save_frames)
            save_gif(frames, f"{movement}.gif")
            logger.info("Wrote %s.gif (%d frames)", movement, len(frames))

    if len(movements) > 1 and total_frames:
        print("MPJPE2D (all): ", tot2 / total_frames)
        print("MPJPE3D (all): ", tot3 / total_frames)
    return results


if __name__ == "__main__":
    main()
