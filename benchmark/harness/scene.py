"""What a traffic mix draws from the run's seed: the stereo rig, the crop
affines of the training augmentation, the poses, and the frames, the
same sizes for every seed."""

from __future__ import annotations

import numpy as np
import torch

from .weights import generator

RIG_DISTANCE_MM, RIG_BASELINE_MM, RIG_FOCAL_256 = 3000.0, 400.0, 1100.0


def converging_rig(width: int, height: int) -> np.ndarray:
    """(2, 4, 4): two cameras 3 m from the origin at x = -+400 mm, each
    turned toward the origin, with a focal length of 1100 px at 256 px
    (scaled with the shorter side) and the principal point at the
    centre."""
    f = RIG_FOCAL_256 * min(width, height) / 256
    K = np.array([[f, 0.0, width / 2], [0.0, f, height / 2], [0, 0, 1.0]])
    out = np.zeros((2, 4, 4))
    for v, cx in enumerate((-RIG_BASELINE_MM, RIG_BASELINE_MM)):
        c = np.array([cx, 0.0, -RIG_DISTANCE_MM])
        z = -c / np.linalg.norm(c)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        out[v, :3] = K @ np.hstack([R, -R @ c[:, None]])
        out[v, 3, 3] = 1.0
    return out.astype(np.float32)


def crop_affine(center, scale: float, rot_deg: float, side: float,
                out: int) -> np.ndarray:
    """(2, 3) mapping the square of side scale * side about `center`,
    turned by rot_deg, onto an out x out crop."""
    a = np.deg2rad(rot_deg)
    k = out / (scale * side)
    R = k * np.array([[np.cos(a), np.sin(a)], [-np.sin(a), np.cos(a)]])
    t = np.array([out / 2, out / 2]) - R @ np.asarray(center, np.float64)
    return np.hstack([R, t[:, None]]).astype(np.float32)


def train_affines(rng, n: int, width: int, height: int, out: int,
                  scale_factor: float, rot_factor: float) -> np.ndarray:
    """(n, 2, 3) training crops about the frame's centre: scale
    clip(N(1, sf), 1 -+ sf), rotation clip(N(0, rf), -+2 rf) in 60% of
    samples (the reference loader's draws)."""
    out_t = []
    for _ in range(n):
        s = np.clip(rng.standard_normal() * scale_factor + 1,
                    1 - scale_factor, 1 + scale_factor)
        r = (np.clip(rng.standard_normal() * rot_factor, -2 * rot_factor,
                     2 * rot_factor) if rng.random() <= 0.6 else 0.0)
        out_t.append(crop_affine((width / 2, height / 2), s, r,
                                 min(width, height), out))
    return np.stack(out_t)


def poses(rng, n: int, joints: int, range_mm: float) -> np.ndarray:
    return rng.uniform(-range_mm, range_mm, (n, joints, 3)).astype(np.float32)


def frames(device, n: int, height: int, width: int, seed: int):
    """(n, height, width, 3) uint8 frames on the device, one draw."""
    return torch.randint(0, 256, (n, height, width, 3), dtype=torch.uint8,
                         generator=generator(device, seed), device=device)
