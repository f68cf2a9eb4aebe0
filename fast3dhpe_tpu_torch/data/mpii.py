"""MPII index builder. Port of fast3dhpe_tpu/data/mpii.py (:16-57).

Parses <root>/annot/{train,valid,test}.json and applies the reference's
centre and scale fixups: c[1] += 15 s and s *= 1.25 where a centre is
given, then MATLAB's 1-based coordinates become 0-based.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

MPII_FLIP_PAIRS = [[0, 5], [1, 4], [2, 3], [10, 15], [11, 14], [12, 13]]
MPII_PARENT_IDS = [1, 2, 6, 6, 3, 4, 6, 6, 7, 8, 11, 12, 7, 7, 13, 14]


def build_mpii_index(root: str, image_set: str,
                     num_joints: int = 16) -> List[Dict]:
    """Records: image, center (2,), scale (2,) in units of 200 px, joints
    and joints_vis (J, 3) float64 (zero for the "test" set, which has no
    joints), score."""
    with open(os.path.join(root, "annot", image_set + ".json")) as f:
        anno = json.load(f)

    records = []
    for a in anno:
        c = np.array(a["center"], dtype=np.float64)
        s = np.array([a["scale"], a["scale"]], dtype=np.float64)
        if c[0] != -1:          # keep the limbs inside the crop
            c[1] = c[1] + 15 * s[1]
            s = s * 1.25
        c = c - 1

        joints_3d = np.zeros((num_joints, 3), dtype=np.float64)
        joints_3d_vis = np.zeros((num_joints, 3), dtype=np.float64)
        if image_set != "test":
            joints = np.array(a["joints"], dtype=np.float64)
            if len(joints) != num_joints:
                raise ValueError(f"joint num diff: {len(joints)} vs "
                                 f"{num_joints}")
            joints_3d[:, 0:2] = joints[:, 0:2] - 1
            joints_vis = np.array(a["joints_vis"], dtype=np.float64)
            joints_3d_vis[:, 0] = joints_vis
            joints_3d_vis[:, 1] = joints_vis

        records.append({
            "image": os.path.join(root, "images", a["image"]),
            "center": c,
            "scale": s,
            "joints": joints_3d,
            "joints_vis": joints_3d_vis,
            "score": a.get("score", 1),
        })
    return records
