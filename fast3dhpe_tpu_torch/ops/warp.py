"""Image preprocessing. Port of fast3dhpe_tpu/ops/warp.py
`normalize_imagenet`."""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_imagenet(images):
    """uint8 or float [0, 255] RGB (..., 3) -> ImageNet-normalised fp32,
    channels last."""
    x = images.float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std
