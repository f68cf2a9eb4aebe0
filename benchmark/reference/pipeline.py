"""Plain references of the training input pipeline on the device: the
crop by a bilinear affine warp, Cutout, the targets and their weights,
and the ImageNet normalisation.

The Cutout holes are drawn as the system under test draws them, so that
both sides occlude the same pixels: a generator on the frames' device,
seeded for step i of a chunk with `step_seed(chunk_seed, i)`, draws the
per-sample gate (B uniforms, occluded where <= 0.3), then the hole
centres' rows (2B x 6 integers below H) and columns (2B x 6 below W); a
hole is the 40 x 40 square about its centre, clipped to the image, and
occluded pixels are 128.
"""

from __future__ import annotations

import numpy as np
import torch

from .geometry import project

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
CUTOUT_HOLES, CUTOUT_LENGTH, CUTOUT_PROB, FILL = 6, 40, 0.3, 128.0


def step_seed(chunk_seed: int, step: int) -> int:
    return int(np.random.SeedSequence((chunk_seed, step)).generate_state(
        1, np.uint64)[0])


def warp(frames, trans, size):
    """frames (N, H0, W0, 3) uint8; trans (N, 2, 3) maps source to output
    pixels -> (N, 3, size, size) fp32 in [0, 255]: output (x, y) samples
    the source at trans^-1 (x, y, 1) bilinearly, each tap outside the frame
    0 on its own (cv2.warpAffine, INTER_LINEAR, zero border)."""
    N, H0, W0, _ = frames.shape
    dev = frames.device
    # the inverse in closed form, in fp32, and the source coordinates
    # summed in the order x, y, offset: the samples' floors are where the
    # crop is most sensitive, and this is how the crop is specified
    a, b, c = trans[:, 0, 0], trans[:, 0, 1], trans[:, 0, 2]
    d, e, f = trans[:, 1, 0], trans[:, 1, 1], trans[:, 1, 2]
    det = a * e - b * d
    i00, i01, i10, i11 = e / det, -b / det, -d / det, a / det
    i02, i12 = -(i00 * c + i01 * f), -(i10 * c + i11 * f)
    g = torch.arange(size, dtype=torch.float32, device=dev)
    gx, gy = g[None, None, :], g[None, :, None]
    sx = i00[:, None, None] * gx + i01[:, None, None] * gy \
        + i02[:, None, None]
    sy = i10[:, None, None] * gx + i11[:, None, None] * gy \
        + i12[:, None, None]
    src = torch.stack([sx, sy], dim=-1)                     # (N, S, S, 2)
    x0, y0 = src[..., 0].floor(), src[..., 1].floor()
    fx, fy = src[..., 0] - x0, src[..., 1] - y0
    out = torch.zeros((N, size, size, 3), dtype=torch.float32, device=dev)
    n = torch.arange(N, device=dev)[:, None, None]
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            xi, yi = x0 + dx, y0 + dy
            inside = (xi >= 0) & (xi < W0) & (yi >= 0) & (yi < H0)
            tap = frames[n, yi.clamp(0, H0 - 1).long(),
                         xi.clamp(0, W0 - 1).long()].float()
            out += torch.where(inside[..., None], tap, 0.0) \
                * (wx * wy)[..., None]
    return out.permute(0, 3, 1, 2)


def normalize(images):
    """(..., 3, H, W) in [0, 255] -> ImageNet-normalised fp32."""
    mean = torch.tensor(MEAN, device=images.device)[:, None, None]
    std = torch.tensor(STD, device=images.device)[:, None, None]
    return (images / 255.0 - mean) / std


def cutout(images, seed):
    """images (B, 2, 3, H, W) -> (images with holes filled, keep
    (B, 2, H, W) bool)."""
    B, V, _, H, W = images.shape
    dev = images.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    gate = torch.rand((B,), generator=gen, device=dev) <= CUTOUT_PROB
    cy = torch.randint(0, H, (B * V, CUTOUT_HOLES), generator=gen, device=dev)
    cx = torch.randint(0, W, (B * V, CUTOUT_HOLES), generator=gen, device=dev)
    half = CUTOUT_LENGTH // 2
    ys = torch.arange(H, device=dev)
    xs = torch.arange(W, device=dev)
    in_y = (ys >= (cy - half).clamp(0, H)[..., None]) \
        & (ys < (cy + half).clamp(0, H)[..., None])         # (BV, 6, H)
    in_x = (xs >= (cx - half).clamp(0, W)[..., None]) \
        & (xs < (cx + half).clamp(0, W)[..., None])
    hole = (in_y[..., :, None] & in_x[..., None, :]).any(dim=1)
    keep = ~hole.reshape(B, V, H, W) | ~gate[:, None, None, None]
    return torch.where(keep[:, :, None], images, FILL), keep


def stereo_batch(frames, x, size, seed):
    """One training batch of stereo pairs from the frame cache.

    x: idx_l, idx_r (B,) frame rows; trans (B, 2, 3); P_l, P_r (B, 4, 4)
    of the raw frames; pose_3d (B, J, 3); joints_vis (B, J). seed: the
    step's Cutout seed. Returns images (B, 2, 3, S, S) normalised, proj
    (B, 2, 3, 4) of the crops, target_2d (B, 2, J, 2), target_3d and
    target_weight (B, J): joints_vis where the joint projects inside both
    crops onto a pixel that no hole covers."""
    B = x["idx_l"].shape[0]
    rows = torch.stack([x["idx_l"], x["idx_r"]], dim=1).flatten().long()
    trans = x["trans"].float()
    crops = warp(frames[rows], trans.repeat_interleave(2, dim=0), size)
    crops, keep = cutout(crops.reshape(B, 2, 3, size, size), seed)
    T = torch.eye(4, device=frames.device).repeat(B, 1, 1)
    T[:, :2, :3] = trans
    proj = torch.stack([T @ x["P_l"].float(), T @ x["P_r"].float()],
                       dim=1)[:, :, :3]
    t2d = project(x["pose_3d"][:, None].float(), proj)       # (B, 2, J, 2)
    inside = ((t2d >= 0) & (t2d < size)).all(-1)            # (B, 2, J)
    px = t2d.clamp(0, size - 1).long()
    b = torch.arange(B, device=frames.device)[:, None, None]
    v = torch.arange(2, device=frames.device)[None, :, None]
    uncovered = keep[b, v, px[..., 1], px[..., 0]]
    weight = x["joints_vis"].float() * (inside & uncovered).all(1)
    return {"images": normalize(crops), "proj": proj, "target_2d": t2d,
            "target_3d": x["pose_3d"].float(), "target_weight": weight}


def gaussian_targets(joints, vis, heatmap, image, sigma):
    """joints (B, J, 2) in image pixels -> targets (B, J, h, w) and weights
    (B, J). The centre is trunc(x / stride + 0.5); the gaussian
    exp(-d^2 / 2 sigma^2) is written within 3 sigma of it on each axis; a
    joint whose window lies wholly outside the heatmap gets weight 0 and
    no gaussian."""
    stride = image / heatmap
    mu = torch.trunc(joints / stride + 0.5)                 # (B, J, 2)
    r = 3 * sigma
    outside = ((mu - r >= heatmap) | (mu + r + 1 < 0)).any(-1)
    weight = torch.where(outside, 0.0, vis.float())
    g = torch.arange(heatmap, dtype=torch.float32, device=joints.device)
    dx = g - mu[..., 0:1]                                   # (B, J, w)
    dy = g - mu[..., 1:2]                                   # (B, J, h)
    gx = torch.where(dx.abs() <= r, torch.exp(-dx * dx / (2 * sigma ** 2)),
                     0.0)
    gy = torch.where(dy.abs() <= r, torch.exp(-dy * dy / (2 * sigma ** 2)),
                     0.0)
    target = gy[..., :, None] * gx[..., None, :]
    return target * (weight > 0.5)[..., None, None], weight


def mono_batch(frames, x, size, heatmap, sigma):
    """One 2D training batch from the frame cache. x: idx (B,) rows, flip
    (B,) mirrors the raw frame left to right before the crop, trans
    (B, 2, 3), joints (B, J, 2) in crop pixels, vis (B, J)."""
    img = frames[x["idx"].long()]
    img = torch.where(x["flip"].bool()[:, None, None, None],
                      img.flip(2), img)
    crops = warp(img, x["trans"].float(), size)
    target, weight = gaussian_targets(x["joints"].float(), x["vis"],
                                      heatmap, size, sigma)
    return {"images": normalize(crops), "target": target,
            "target_weight": weight}
