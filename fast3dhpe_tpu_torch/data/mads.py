"""MADS index builders, single-view 2D and stereo 3D. Port of
fast3dhpe_tpu/data/mads.py (:26-132).

Globs the extracted tree

    <root>/<image_set>/<movement>/<sequence>/{left,right,pose}/NNNN.{jpg,json}

parses each frame's calibration and 3D pose JSON, and returns record dicts
of numpy arrays. Decoding, warping and targets come later, in the loader
and the device pipeline.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List

import numpy as np

from ..geometry.camera import project_3d_to_2d

MADS_FLIP_PAIRS = [[2, 6], [3, 7], [4, 8], [5, 9], [10, 14],
                   [11, 15], [12, 16], [13, 17]]
MADS_PARENT_IDS = [0, 0, 1, 2, 3, 4, 1, 6, 7, 8, 0, 10, 11,
                   12, 0, 14, 15, 16, 0]


def _projection_matrix(K, R, T):
    """P = [K [R|T]; 0 0 0 1] in float64."""
    P = np.asarray(K) @ np.hstack((np.asarray(R), np.asarray(T)))
    return np.vstack((P, np.array([0.0, 0.0, 0.0, 1.0])))


def _load_pose_json(path: str):
    with open(path, "r") as f:
        data = json.load(f)
    return data["calibs_info"], np.array(data["pose_3d"], dtype=np.float64)


def _nan_to_invisible(pose_3d):
    """Zero the NaN coordinates in place; (J, 3) visibility, 0 where NaN."""
    mask = np.isnan(pose_3d)
    pose_3d[mask] = 0
    joints_vis = np.ones_like(pose_3d)
    joints_vis[mask] = 0
    return joints_vis


def _missing(root, image_set, layout):
    return FileNotFoundError(
        f"No MADS frames under {os.path.join(root, image_set)}: run "
        f"apps/extract_data.py first (expected "
        f"<root>/<set>/<movement>/<seq>/{layout})")


def build_mads_index(root: str, image_set: str) -> List[Dict]:
    """Single-view (right camera) 2D records: image, joints (J, 3) as the
    3D pose projected through the right camera (x, y, depth), joints_vis
    (J, 3). NaN joints become 0 with visibility 0."""
    right_img_paths = sorted(glob.glob(
        os.path.join(root, image_set, "**/**/right/*.jpg")))
    gt_pose_paths = sorted(glob.glob(
        os.path.join(root, image_set, "**/**/pose/*.json")))
    if len(right_img_paths) != len(gt_pose_paths):
        raise ValueError("Number of images and ground truths must match")
    if not right_img_paths:
        raise _missing(root, image_set, "right/*.jpg")

    records = []
    for img_path, pose_path in zip(right_img_paths, gt_pose_paths):
        calibs_info, pose_3d = _load_pose_json(pose_path)
        cam = calibs_info["cam_right"]
        joints_vis = _nan_to_invisible(pose_3d)
        pose_2d = project_3d_to_2d(pose_3d, np.array(cam["intrinsics"]),
                                   np.array(cam["rotation"]),
                                   np.array(cam["translation"]))
        records.append({
            "image": img_path,
            "joints": pose_2d.numpy().astype(np.float64),
            "joints_vis": joints_vis,
        })
    return records


def build_mads_stereo_index(root: str, image_set: str) -> List[Dict]:
    """Stereo records: image_left / image_right, P_left / P_right (4, 4)
    float64, pose_3d (J, 3) with NaN joints zeroed, and joints_vis (J, 1)
    bool, true where all three coordinates were finite."""
    left_img_paths = sorted(glob.glob(
        os.path.join(root, image_set, "**/**/left/*.jpg")))
    right_img_paths = sorted(glob.glob(
        os.path.join(root, image_set, "**/**/right/*.jpg")))
    gt_pose_paths = sorted(glob.glob(
        os.path.join(root, image_set, "**/**/pose/*.json")))
    if not (len(left_img_paths) == len(right_img_paths)
            == len(gt_pose_paths)):
        raise ValueError("Number of images and ground truths must match")
    if not left_img_paths:
        raise _missing(root, image_set, "{left,right,pose}/")

    records = []
    for left, right, pose_path in zip(left_img_paths, right_img_paths,
                                      gt_pose_paths):
        calibs_info, pose_3d = _load_pose_json(pose_path)
        joints_vis = np.logical_and.reduce(_nan_to_invisible(pose_3d),
                                           axis=1, keepdims=True)
        P = {side: _projection_matrix(calibs_info[f"cam_{side}"]["intrinsics"],
                                      calibs_info[f"cam_{side}"]["rotation"],
                                      calibs_info[f"cam_{side}"]["translation"])
             for side in ("left", "right")}
        records.append({
            "image_left": left,
            "image_right": right,
            "P_left": P["left"],
            "P_right": P["right"],
            "joints_vis": joints_vis,
            "pose_3d": pose_3d,
        })
    return records
