"""Occlusion augmentations on the device: Cutout and Hide-and-Seek. Port of
fast3dhpe_tpu/ops/occlusion.py (:23-98).

Each is split into a draw from a torch.Generator on the images' device
and a pure mask builder that takes the draws, so that a test can feed
the builders the numbers JAX drew (the two RNGs never agree bit for
bit). Occluded pixels are set to 128 (gray), and each function returns
the images and a keep-mask that is True where a pixel is not occluded.
"""

from __future__ import annotations

import torch

FILL_VALUE = 128.0


def fill_occluded(images, keep):
    """images (B, H, W, C) with the pixels where keep (B, H, W) is False
    set to FILL_VALUE."""
    # a fill, not a tensor from host data: a CUDA graph captures it
    return torch.where(keep[..., None], images,
                       images.new_full((), FILL_VALUE))


def cutout_draw(gen, batch, height, width, n_holes: int = 6):
    """Hole centres, uniform over [0, H) and [0, W): (cy, cx), each
    (B, n_holes) int64 on the generator's device."""
    dev = gen.device
    cy = torch.randint(0, height, (batch, n_holes), generator=gen, device=dev)
    cx = torch.randint(0, width, (batch, n_holes), generator=gen, device=dev)
    return cy, cx


def cutout_mask(cy, cx, height, width, length: int = 40):
    """Keep-mask (B, H, W) of `length`-square holes centred at (cy, cx),
    each edge clipped to the image."""
    half = length // 2
    y1, y2 = (cy - half).clamp(0, height), (cy + half).clamp(0, height)
    x1, x2 = (cx - half).clamp(0, width), (cx + half).clamp(0, width)
    ys = torch.arange(height, device=cy.device)
    xs = torch.arange(width, device=cx.device)
    in_y = (ys >= y1[..., None]) & (ys < y2[..., None])    # (B, n, H)
    in_x = (xs >= x1[..., None]) & (xs < x2[..., None])    # (B, n, W)
    hole = (in_y[:, :, :, None] & in_x[:, :, None, :]).any(dim=1)
    return ~hole


def cutout(gen, images, n_holes: int = 6, length: int = 40):
    """Cutout: n_holes length x length gray squares an image.
    Returns (images_out, keep_mask (B, H, W))."""
    B, H, W, _ = images.shape
    keep = cutout_mask(*cutout_draw(gen, B, H, W, n_holes), H, W, length)
    return fill_occluded(images, keep), keep


def hide_n_seek_draw(gen, batch, n_patches: int = 4):
    """Uniform scores (B, n_patches^2), one a grid cell."""
    return torch.rand((batch, n_patches * n_patches), generator=gen,
                      device=gen.device)


def hide_n_seek_mask(scores, height, width, n_patches: int = 4,
                     p_hide: float = 0.4):
    """Keep-mask (B, H, W) hiding exactly int(p_hide * n^2) cells of an
    n x n grid: those of the lowest scores (drawn without replacement).
    The cell length is H // n_patches on both axes, and the rows and
    columns at or beyond n_patches * length are never hidden."""
    B = scores.shape[0]
    length = height // n_patches
    n_hide = int(p_hide * n_patches * n_patches)
    ranks = torch.argsort(torch.argsort(scores, dim=-1, stable=True),
                          dim=-1, stable=True)
    hide_cell = (ranks < n_hide).reshape(B, n_patches, n_patches)
    ys = torch.arange(height, device=scores.device)
    xs = torch.arange(width, device=scores.device)
    cell_y = (ys // length).clamp(0, n_patches - 1)
    cell_x = (xs // length).clamp(0, n_patches - 1)
    hole = hide_cell[:, cell_y][:, :, cell_x]              # (B, H, W)
    hole = (hole & (ys < n_patches * length)[None, :, None]
            & (xs < n_patches * length)[None, None, :])
    return ~hole


def hide_n_seek(gen, images, n_patches: int = 4, p_hide: float = 0.4):
    """Hide-and-Seek. Returns (images_out, keep_mask (B, H, W))."""
    B, H, W, _ = images.shape
    keep = hide_n_seek_mask(hide_n_seek_draw(gen, B, n_patches), H, W,
                            n_patches, p_hide)
    return fill_occluded(images, keep), keep
