"""CDRNet stereo inference. Port of fast3dhpe_tpu/apps/inference.py
`CDRNetInferencer` (:33-185): weights in, stereo batches of uint8 frames
to pred_2d / pred_3d out.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from ..convert import load_state_dict_file
from ..device import resolve_device
from ..models.cdrnet import CDRNet
from ..ops.warp import affine_warp, normalize_imagenet


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

    def evaluate_movement(self, stream, batch_size: int = 32,
                          device_cache_bytes: int = 0):
        raise NotImplementedError(
            "evaluate_movement needs the MADS stream (slice 4, host data) "
            "and the eval loop (slice 5) of the port")
