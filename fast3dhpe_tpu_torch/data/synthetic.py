"""Synthetic MADS- and MPII-format dataset trees. The port's own copy of
fast3dhpe_tpu/data/synthetic.py (:22-165): the same layout, rig, poses,
frames and JSON, byte for byte.

    <root>/{train,valid}/<movement>/<seq>/{left,right,pose}/NNNN.{jpg,json}

A consistent stereo rig (one K, two cameras offset on x), a moving
19-joint skeleton, and frames with bright dots at the joints' true 2D
projections, so that decode and geometry round trips can be checked.
JPEGs are written by cv2, else PIL (quality 95 either way).
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np


def synthetic_rig(img_w: int = 512, img_h: int = 384):
    K = np.array([[600.0, 0.0, img_w / 2],
                  [0.0, 600.0, img_h / 2],
                  [0.0, 0.0, 1.0]])
    R = np.eye(3)
    calibs = {}
    for name, dx in (("cam_left", -300.0), ("cam_right", 300.0)):
        T = np.array([[dx], [100.0], [3000.0]])
        calibs[name] = {
            "intrinsics": K.tolist(),
            "rotation": R.tolist(),
            "translation": T.tolist(),
        }
    return calibs


def synthetic_pose(t: float, num_joints: int = 19) -> np.ndarray:
    """A deterministic moving skeleton, roughly human-scaled (mm)."""
    rng = np.random.RandomState(42)
    base = rng.uniform(-300, 300, size=(num_joints, 3))
    base[:, 2] = np.linspace(0, 1500, num_joints)
    wob = np.stack([
        100 * np.sin(t + np.arange(num_joints)),
        100 * np.cos(t * 1.3 + np.arange(num_joints)),
        50 * np.sin(t * 0.7 + np.arange(num_joints)),
    ], axis=1)
    return base + wob


def _project(pose_3d, cam):
    K = np.array(cam["intrinsics"])
    R = np.array(cam["rotation"])
    T = np.array(cam["translation"])
    p = (R @ pose_3d.T + T).T
    uv = (K @ p.T).T
    return uv[:, :2] / uv[:, 2:]


def _render_frame(pose_2d, img_w, img_h, radius: int = 2):
    """Gray image with bright (2r+1)x(2r+1) dots at the joint projections."""
    img = np.full((img_h, img_w, 3), 60, np.uint8)
    r = radius
    for x, y in pose_2d:
        xi, yi = int(round(x)), int(round(y))
        if r <= xi < img_w - r and r <= yi < img_h - r:
            img[yi - r:yi + r + 1, xi - r:xi + r + 1] = (255, 220, 180)
    return img


def _write_jpg(path, img):
    """BGR uint8 -> JPEG at quality 95 (cv2's default), by cv2 or PIL."""
    try:
        import cv2
    except ImportError:
        try:
            from PIL import Image
        except ImportError:
            raise RuntimeError("writing a JPEG needs cv2 or PIL; neither "
                               "is installed") from None
        Image.fromarray(img[:, :, ::-1]).save(path, quality=95)
        return
    if not cv2.imwrite(path, img):
        raise OSError(f"cv2 could not write {path}")


def make_synthetic_mpii(root: str, n_train: int = 24, n_valid: int = 8,
                        num_joints: int = 16,
                        base_hw: Tuple[int, int] = (240, 320),
                        vary: int = 16) -> str:
    """MPII-format annot tree (images/ + annot/{train,valid}.json) with
    VARIABLE frame sizes — the layout data/mpii.build_mpii_index parses
    [ref: dataset/mpii.py:60-96]. Joints are drawn as bright dots so a
    2D model can actually learn the mapping (training smoke tests), and
    are stored 1-BASED like real MPII (the index applies the matlab -1
    shift). Returns root."""
    os.makedirs(os.path.join(root, "annot"), exist_ok=True)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    rng = np.random.RandomState(7)
    for split, n in (("train", n_train), ("valid", n_valid)):
        entries = []
        for i in range(n):
            h = base_hw[0] + vary * (i % 5)
            w = base_hw[1] + (vary // 2) * (i % 7)
            name = f"{split}_{i:04d}.jpg"
            t = i * 0.4 + (0.0 if split == "train" else 25.0)
            # deterministic wobbling joints within the frame interior
            jr = np.random.RandomState(42)
            base = np.stack([jr.uniform(0.2, 0.8, num_joints) * w,
                             jr.uniform(0.2, 0.8, num_joints) * h], axis=1)
            wob = np.stack([
                0.08 * w * np.sin(t + np.arange(num_joints)),
                0.08 * h * np.cos(t * 1.3 + np.arange(num_joints)),
            ], axis=1)
            joints = base + wob
            # fat dots: frames are ~240-340 px but training smokes warp
            # to 64 px — a 5x5 dot would vanish to a single pixel
            img = _render_frame(joints, w, h, radius=7)
            # light per-image texture so it is not a constant background
            img = img.astype(np.int16) + rng.randint(
                -10, 10, size=(h, w, 1), dtype=np.int16)
            _write_jpg(os.path.join(root, "images", name),
                       np.clip(img, 0, 255).astype(np.uint8))
            entries.append({
                "image": name,
                "center": [w / 2, h / 2],
                "scale": h / 200.0,
                "joints": (joints + 1.0).tolist(),   # 1-based like MPII
                "joints_vis": [1] * num_joints,
            })
        with open(os.path.join(root, "annot", f"{split}.json"), "w") as f:
            json.dump(entries, f)
    return root


def make_synthetic_mads(root: str, n_frames: int = 8,
                        movements: Tuple[str, ...] = ("HipHop",),
                        img_w: int = 512, img_h: int = 384,
                        num_joints: int = 19,
                        splits: Tuple[str, ...] = ("train", "valid"),
                        nan_joint_every: int = 0) -> str:
    """Build the tree; returns root. `nan_joint_every`: every k-th frame
    gets one NaN joint (tests the visibility masking path)."""
    calibs = synthetic_rig(img_w, img_h)
    for split in splits:
        for mv in movements:
            seq = "Take_1"
            base = os.path.join(root, split, mv, seq)
            for sub in ("left", "right", "pose"):
                os.makedirs(os.path.join(base, sub), exist_ok=True)
            for f in range(n_frames):
                t = f * 0.3 + (0.0 if split == "train" else 50.0)
                pose = synthetic_pose(t, num_joints)
                pose_out = pose.copy()
                if nan_joint_every and f % nan_joint_every == 0:
                    pose_out[f % num_joints] = np.nan

                for cam_name, sub in (("cam_left", "left"),
                                      ("cam_right", "right")):
                    uv = _project(pose, calibs[cam_name])
                    img = _render_frame(uv, img_w, img_h)
                    _write_jpg(os.path.join(base, sub, f"{f:04d}.jpg"), img)

                with open(os.path.join(base, "pose", f"{f:04d}.json"),
                          "w") as fp:
                    # python's json writes NaN literals and reads them back
                    # (matching how the reference ETL stores missing joints)
                    json.dump({
                        "calibs_info": calibs,
                        "pose_3d": pose_out.tolist(),
                    }, fp)
    return root
