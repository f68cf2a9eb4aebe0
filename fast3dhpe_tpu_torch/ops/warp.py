"""Image preprocessing on the device. Port of fast3dhpe_tpu/ops/warp.py:
`affine_warp` (:32-95) and `normalize_imagenet` (:98-112).

The JAX package runs the warp outside Pallas on purpose (a data-dependent
4-tap gather), and so does the port: PyTorch's own gathers and
elementwise ops. Each tap is gathered straight from the uint8 frames and
cast to fp32 before the interpolation, so no fp32 copy of a full-size
frame is made.
"""

from __future__ import annotations

import functools

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def invert_affine(trans):
    """Invert (..., 2, 3) fp32 affines by the closed form of the JAX
    package (ops/warp.py:32-42), in fp32."""
    A, b = trans[..., :, :2], trans[..., :, 2]
    det = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    inv = torch.stack([
        torch.stack([A[..., 1, 1], -A[..., 0, 1]], dim=-1),
        torch.stack([-A[..., 1, 0], A[..., 0, 0]], dim=-1),
    ], dim=-2) / det[..., None, None]
    b_inv = -(inv[..., 0] * b[..., 0, None] + inv[..., 1] * b[..., 1, None])
    return torch.cat([inv, b_inv[..., None]], dim=-1)


def affine_warp(images, trans, out_size):
    """Warp a batch of images with per-image 2x3 affines, cv2.warpAffine
    INTER_LINEAR semantics with a zero border.

    Output pixel (x, y) samples the source at inv(trans) @ (x, y, 1), with
    no half-pixel offset, bilinearly from four taps; a tap outside the
    source contributes 0 on its own, so the border is continuous.

    Args:
      images: (B, H, W, C) uint8 or float, on any device.
      trans: (B, 2, 3) or (2, 3) affine mapping source to output pixels.
      out_size: (W_out, H_out), width first as in cv2.
    Returns:
      (B, H_out, W_out, C) fp32 on the images' device.
    """
    W_out, H_out = out_size
    B, H, W, C = images.shape
    dev = images.device
    trans = torch.as_tensor(trans, dtype=torch.float32, device=dev)
    if trans.dim() == 2:
        trans = trans.expand(B, 2, 3)
    inv = invert_affine(trans)[:, :, :, None, None]        # (B, 2, 3, 1, 1)
    gx = torch.arange(W_out, dtype=torch.float32, device=dev)[None, :]
    gy = torch.arange(H_out, dtype=torch.float32, device=dev)[:, None]
    sx = inv[:, 0, 0] * gx + inv[:, 0, 1] * gy + inv[:, 0, 2]  # (B, Ho, Wo)
    sy = inv[:, 1, 0] * gx + inv[:, 1, 1] * gy + inv[:, 1, 2]

    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    # the four taps at once: rows y0 + (0, 1) x columns x0 + (0, 1)
    step = torch.arange(2, dtype=torch.float32, device=dev)[:, None, None,
                                                            None]
    xs, ys = x0 + step, y0 + step                          # (2, B, Ho, Wo)
    valid = (((ys >= 0) & (ys < H))[:, None]
             & ((xs >= 0) & (xs < W))[None])               # (2, 2, B, ...)
    base = (torch.arange(B, device=dev) * (H * W))[:, None, None]
    idx = (base + ys.clamp(0, H - 1).long() * W)[:, None] \
        + xs.clamp(0, W - 1).long()[None]
    taps = images.reshape(B * H * W, C)[idx].float()       # (2, 2, B, ..., C)
    taps = torch.where(valid[..., None], taps, 0.0)
    rows = taps[:, 0] * (1 - fx) + taps[:, 1] * fx         # top, bottom
    return rows[0] * (1 - fy) + rows[1] * fy


def _new_mean_std(device):
    return (torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device),
            torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device))


@functools.lru_cache(maxsize=None)
def _mean_std(device: torch.device):
    """ImageNet mean and std as fp32 tensors on `device`, made once."""
    return _new_mean_std(device)


def normalize_imagenet(images):
    """uint8 or float [0, 255] RGB (..., 3) -> ImageNet-normalised fp32,
    channels last. While torch.export traces, the constants are made anew
    (the cache would keep the tracer's fake tensors)."""
    x = images.float() / 255.0
    mean, std = (_new_mean_std(x.device) if torch.compiler.is_compiling()
                 else _mean_std(x.device))
    return (x - mean) / std
