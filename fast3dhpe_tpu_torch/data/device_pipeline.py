"""Batched preprocessing on the device. Port of
fast3dhpe_tpu/data/device_pipeline.py (:28-289).

A stereo training batch goes, on the device that holds its frames:

  uint8 raw frames -> affine crop (ops/warp.py) -> (train) Cutout or
  Hide-and-Seek, gated per sample -> P <- T @ P -> GT reprojection ->
  (train) visibility: boundary, then occlusion -> ImageNet normalisation

The host draws only the per-sample affines. Where the JAX core takes a
PRNG key, the port takes a torch.Generator on the batch's device; it
draws the gate (B,), then the holes or cell scores of the 2B images. The
two views of a batch go through each step together, as (B, 2, ...)
tensors, which halves the launches of a batch. Nothing here moves a
tensor to another device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..geometry.camera import project_points
from ..ops.heatmap import render_gaussian_heatmaps
from ..ops.occlusion import (cutout_draw, cutout_mask, fill_occluded,
                             hide_n_seek_draw, hide_n_seek_mask)
from ..ops.warp import affine_warp, normalize_imagenet


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _rows(x, device):
    return torch.as_tensor(x, dtype=torch.long, device=device)


def compose_projection_batched(P, trans):
    """P <- T @ P with T = eye(4), T[:2, :3] = trans: P (B, 4, 4), trans
    (B, 2, 3) -> (B, 4, 4) fp32."""
    P = _f32(P, None)
    trans = _f32(trans, P.device)
    T = torch.eye(4, device=P.device).repeat(P.shape[0], 1, 1)
    T[:, :2, :3] = trans
    return torch.einsum("bij,bjk->bik", T, P)


def _check_boundary(pose_2d, height, width):
    """Joints outside the (H, W) image get coordinates (-1, -1); returns
    (pose_2d, valid)."""
    valid = ((pose_2d[..., 0] >= 0) & (pose_2d[..., 0] < width)
             & (pose_2d[..., 1] >= 0) & (pose_2d[..., 1] < height))
    return torch.where(valid[..., None], pose_2d, -1.0), valid


def _check_occlusion(pose_2d, keep_mask):
    """The keep-mask (B, H, W) at each joint's pixel, (B, J) bool.
    Coordinates truncate toward zero to int32; a -1 wraps to the last
    pixel, as numpy's negative index does in the reference; then clip."""
    x = pose_2d[..., 0].to(torch.int32)
    y = pose_2d[..., 1].to(torch.int32)
    H, W = keep_mask.shape[-2:]
    x = torch.where(x < 0, x + W, x).clamp(0, W - 1)
    y = torch.where(y < 0, y + H, y).clamp(0, H - 1)
    flat = keep_mask.reshape(keep_mask.shape[0], -1)
    return torch.gather(flat, 1, (y * W + x).long())


def occlude_stereo(gen, warped, occlusion: str, occl_prob: float = 0.3):
    """Cutout ("CUTOUT") or Hide-and-Seek ("HNS") on both views of
    warped (B, 2, H, W, 3), with one gate a sample for both views:
    uniform <= occl_prob. Returns (warped, keep (B, 2, H, W))."""
    B, V, H, W, _ = warped.shape
    gate = torch.rand((B,), generator=gen, device=gen.device) <= occl_prob
    if occlusion == "CUTOUT":
        mask = cutout_mask(*cutout_draw(gen, B * V, H, W), H, W)
    else:
        mask = hide_n_seek_mask(hide_n_seek_draw(gen, B * V), H, W)
    keep = mask.view(B, V, H, W) | ~gate[:, None, None, None]
    return fill_occluded(warped, keep), keep


def finish_stereo(warped, keep, trans, P_l, P_r, pose_3d, joints_vis,
                  occlusion: Optional[str] = None, train: bool = False,
                  return_masks: bool = False):
    """The stereo core after occlusion: P <- T @ P, the GT reprojection,
    the visibility (train only; the occlusion term only with occlusion on)
    and the normalisation. warped: (B, 2, H, W, 3) fp32 after occlusion;
    keep: (B, 2, H, W) bool."""
    dev = warped.device
    B, V, H, W, _ = warped.shape
    trans = _f32(trans, dev)
    P = torch.stack([_f32(P_l, dev), _f32(P_r, dev)], dim=1)   # (B, 2, 4, 4)
    proj = compose_projection_batched(
        P.flatten(0, 1), trans.repeat_interleave(V, dim=0)).view(
            B, V, 4, 4)[:, :, :3]
    pose_3d = _f32(pose_3d, dev)
    t2d = project_points(pose_3d[:, None], proj)                # (B, 2, J, 2)

    weight = _f32(joints_vis, dev)
    if train:
        t2d, valid = _check_boundary(t2d, H, W)
        weight = weight * valid[:, 0] * valid[:, 1]
        if occlusion not in (None, "None"):
            vis = _check_occlusion(t2d.flatten(0, 1), keep.flatten(0, 1))
            vis = vis.view(B, V, -1)
            weight = weight * (vis[:, 0] & vis[:, 1])
    out = {"image": normalize_imagenet(warped), "proj": proj,
           "target_3d": pose_3d, "target_2d": t2d, "target_weight": weight}
    if return_masks:
        out["keep_mask"] = keep
    return out


def _stereo_core(gen, frames, trans, P_l, P_r, pose_3d, joints_vis,
                 image_size, occlusion, train, occl_prob, return_masks):
    """frames: (2B, H0, W0, 3) uint8, sample b's left view at row 2b and
    its right view at 2b + 1: both views are warped in one call."""
    W, H = image_size
    B = frames.shape[0] // 2
    trans = _f32(trans, frames.device)
    warped = affine_warp(frames, trans.repeat_interleave(2, dim=0),
                         image_size).view(B, 2, H, W, 3)
    if train and occlusion not in (None, "None"):
        warped, keep = occlude_stereo(gen, warped, occlusion, occl_prob)
    else:
        keep = torch.ones((B, 2, H, W), dtype=torch.bool,
                          device=frames.device)
    return finish_stereo(warped, keep, trans, P_l, P_r, pose_3d, joints_vis,
                         occlusion=occlusion, train=train,
                         return_masks=return_masks)


def _pair_rows(idx_l, idx_r, device):
    """(B,) left and right rows -> (2B,) rows, the views of a sample
    adjacent."""
    return torch.stack([_rows(idx_l, device), _rows(idx_r, device)],
                       dim=1).flatten()


def preprocess_stereo_batch(gen, img_l, img_r, trans, P_l, P_r, pose_3d,
                            joints_vis, image_size: Tuple[int, int],
                            occlusion: Optional[str] = None,
                            train: bool = False, occl_prob: float = 0.3,
                            return_masks: bool = False):
    """Stereo preprocessing on the frames' device.

    Args:
      gen: torch.Generator on the frames' device (occlusion draws; unused
        when no occlusion runs).
      img_l, img_r: (B, H0, W0, 3) uint8 raw frames.
      trans: (B, 2, 3) per-sample affines; P_l, P_r: (B, 4, 4) raw
        projections; pose_3d: (B, J, 3) world GT; joints_vis: (B, J).
      image_size: (W, H) output size.
      occlusion: None | "None" | "CUTOUT" | "HNS", applied only in
        training, as is the visibility processing.
      return_masks: also return the keep-masks (B, 2, H, W).
    Returns:
      dict: image (B, 2, H, W, 3) normalised; proj (B, 2, 3, 4);
      target_3d (B, J, 3); target_2d (B, 2, J, 2); target_weight (B, J).
    """
    frames = torch.stack([torch.as_tensor(img_l), torch.as_tensor(img_r)],
                         dim=1).flatten(0, 1)
    return _stereo_core(gen, frames, trans, P_l, P_r, pose_3d, joints_vis,
                        image_size, occlusion, train, occl_prob,
                        return_masks)


def preprocess_stereo_batch_cached(gen, frames, idx_l, idx_r, trans, P_l,
                                   P_r, pose_3d, joints_vis,
                                   image_size: Tuple[int, int],
                                   occlusion: Optional[str] = None,
                                   train: bool = False,
                                   occl_prob: float = 0.3,
                                   return_masks: bool = False):
    """preprocess_stereo_batch fed from a device frame cache: frames is
    the (N, H0, W0, 3) uint8 tensor of data/device_cache.py, idx_l / idx_r
    the (B,) rows of each sample's views. Pass the rows as a tensor on
    the frames' device: a host array is a copy to the device a call."""
    batch = frames.index_select(0, _pair_rows(idx_l, idx_r, frames.device))
    return _stereo_core(gen, batch, trans, P_l, P_r, pose_3d, joints_vis,
                        image_size, occlusion, train, occl_prob,
                        return_masks)


def preprocess_stereo_batch_partial(gen, frames, idx_l, idx_r, up_l, up_r,
                                    trans, P_l, P_r, pose_3d, joints_vis,
                                    image_size: Tuple[int, int],
                                    occlusion: Optional[str] = None,
                                    train: bool = False,
                                    occl_prob: float = 0.3,
                                    return_masks: bool = False):
    """preprocess_stereo_batch fed from a partial frame cache: the first
    len(idx_l) rows gather from `frames`, the len(up_l) rows after them
    are the uploaded raw frames of the cache misses. trans, P_*, pose_3d
    and joints_vis cover the whole batch in that order."""
    dev = frames.device
    up = torch.stack([torch.as_tensor(up_l, device=dev),
                      torch.as_tensor(up_r, device=dev)], dim=1)
    batch = torch.cat([frames.index_select(0, _pair_rows(idx_l, idx_r, dev)),
                       up.flatten(0, 1)])
    return _stereo_core(gen, batch, trans, P_l, P_r, pose_3d, joints_vis,
                        image_size, occlusion, train, occl_prob,
                        return_masks)


def preprocess_mono_batch(img, trans, joints, joints_vis,
                          image_size: Tuple[int, int],
                          heatmap_size: Tuple[int, int], sigma: int = 3):
    """Mono 2D preprocessing: warp, normalise, render the gaussian targets.

    Args:
      img: (B, H0, W0, 3) uint8, already flipped where the host flipped.
      trans: (B, 2, 3); joints: (B, J, 2) in output pixels; joints_vis
        (B, J).
    Returns:
      dict: image (B, H, W, 3); target (B, h, w, J); target_weight (B, J).
    """
    warped = affine_warp(img, trans, image_size)
    target, weight = render_gaussian_heatmaps(
        _f32(joints, img.device), _f32(joints_vis, img.device),
        heatmap_size, image_size, sigma)
    return {"image": normalize_imagenet(warped), "target": target,
            "target_weight": weight}


def _flipped(img, flip):
    """Mirror the rows of img (B, H, W, 3) where flip (B,) is set."""
    flip = torch.as_tensor(flip, dtype=torch.bool, device=img.device)
    return torch.where(flip[:, None, None, None], torch.flip(img, dims=(2,)),
                       img)


def preprocess_mono_batch_cached(frames, idx, flip, trans, joints,
                                 joints_vis, image_size: Tuple[int, int],
                                 heatmap_size: Tuple[int, int],
                                 sigma: int = 3):
    """preprocess_mono_batch fed from a device frame cache: idx (B,) rows;
    flip (B,) bool mirrors the raw frame on the device (the joints were
    flipped on the host)."""
    img = frames.index_select(0, _rows(idx, frames.device))
    return preprocess_mono_batch(_flipped(img, flip), trans, joints,
                                 joints_vis, image_size=image_size,
                                 heatmap_size=heatmap_size, sigma=sigma)


def preprocess_mono_batch_partial(frames, idx, up, flip, trans, joints,
                                  joints_vis, image_size: Tuple[int, int],
                                  heatmap_size: Tuple[int, int],
                                  sigma: int = 3):
    """preprocess_mono_batch fed from a partial frame cache: the cached
    rows first, then the uploaded (unflipped) raw frames; flip covers the
    whole batch in that order."""
    dev = frames.device
    img = torch.cat([frames.index_select(0, _rows(idx, dev)),
                     torch.as_tensor(up, device=dev)])
    return preprocess_mono_batch(_flipped(img, flip), trans, joints,
                                 joints_vis, image_size=image_size,
                                 heatmap_size=heatmap_size, sigma=sigma)
