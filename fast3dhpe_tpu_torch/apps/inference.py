"""CDRNet stereo inference. Port of fast3dhpe_tpu/apps/inference.py
`CDRNetInferencer` (:33-241): weights in, stereo batches of uint8 frames
to pred_2d / pred_3d out, and a movement's sequence MPJPE.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..convert import load_state_dict_file
from ..device import resolve_device
from ..geometry.camera import project_points
from ..models.cdrnet import CDRNet
from ..models.metrics import per_sample_mpjpe
from ..ops.warp import affine_warp, normalize_imagenet
from .eval_loop import accum_eval, evaluate_stream, ground_truth, \
    make_cached_eval


def find_weights(weights_root: str, name: str) -> str:
    """weights_root/<name>/{best,latest}.pth, the first that exists."""
    path = os.path.join(weights_root, name)
    for cand in ("best", "latest"):
        if os.path.isfile(os.path.join(path, cand + ".pth")):
            return os.path.join(path, cand + ".pth")
        if os.path.isdir(os.path.join(path, cand)):
            raise NotImplementedError(
                f"{os.path.join(path, cand)} is an orbax checkpoint; loading "
                f"those is slice 5 (loops and checkpoints) of the port")
    raise FileNotFoundError(f"No checkpoint found at {path}")


class CDRNetInferencer:
    """Loads weights/<MODEL.NAME>/best.pth (or takes a state dict) and
    predicts stereo batches on one device."""

    def __init__(self, config, weights_root: str = "weights",
                 dtype=torch.float32, fused_inference: bool = False,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 device="cuda", int8: bool = False):
        if int8:
            raise NotImplementedError(
                "int8 serving is slice 6 (int8, export, multi-GPU) of the "
                "port")
        self.device = resolve_device(device)
        self.config = config
        if state_dict is None:
            state_dict = load_state_dict_file(
                find_weights(weights_root, config.MODEL.NAME))
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
