"""Host-side visualization: 2D overlays, 3D skeleton plots, loss curves,
GIFs. The port's copy of fast3dhpe_tpu/utils/visualize.py, which imports
no JAX; the port keeps its own so that it imports nothing of that
package. cv2, matplotlib and PIL are imported where they draw, and a
missing matplotlib raises an ImportError that names it.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

# MADS skeleton connections [ref: tools/utils.py:78-87]
MADS_CONNECTIONS = [
    (0, 1),                             # body
    (0, 18),                            # head
    (1, 6), (6, 7), (7, 8), (8, 9),     # left leg
    (0, 14), (14, 15), (15, 16), (16, 17),  # left arm
    (1, 2), (2, 3), (3, 4), (4, 5),     # right leg
    (0, 10), (10, 11), (11, 12), (12, 13),  # right arm
]


def _draw_joints(img, joints, color):
    import cv2
    for joint in np.asarray(joints):
        if not np.isnan(joint[0]) and not np.isnan(joint[1]):
            cv2.circle(img, (int(joint[0]), int(joint[1])), 2, color, -1)


def plot_pose_2d(gt_joints: Sequence, pred_joints: Sequence,
                 imgs: Sequence) -> np.ndarray:
    """GT (blue) + prediction (green) overlays, views h-concatenated.
    [ref: tools/utils.py:134-150]"""
    imgs = [np.ascontiguousarray(i) for i in imgs]
    for gt, pred, img in zip(gt_joints, pred_joints, imgs):
        _draw_joints(img, gt, (255, 0, 0))
        _draw_joints(img, pred, (0, 255, 0))
    return np.concatenate(imgs, axis=1)


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "matplotlib is not installed: plot_pose_3d and plot_loss (the "
            "--save_frames 3D plots and --plot_dir curves) need it") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_pose_3d(pose_3d: np.ndarray, pred_3d: np.ndarray) -> np.ndarray:
    """GT vs estimated 3D skeletons on fixed world axes, rendered to an
    RGB array. [ref: tools/utils.py:101-131]"""
    plt = _pyplot()
    from scipy.spatial.transform import Rotation

    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    ax.set_xlim3d(-1000, 1000)
    ax.set_ylim3d(-1500, 1500)
    ax.set_zlim3d(0, 1700)

    rot = Rotation.from_euler("zyx", np.array([0, 0, 90]),
                              degrees=True).as_matrix()
    pose_3d = (rot @ np.asarray(pose_3d).T).T
    pred_3d = (rot @ np.asarray(pred_3d).T).T

    for pts, color, label in ((pose_3d, "#03459c", "ground truth"),
                              (pred_3d, "#27d128", "estimation")):
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=color, marker="o", s=2)
        for a, b in MADS_CONNECTIONS:
            ax.plot([pts[a, 0], pts[b, 0]], [pts[a, 1], pts[b, 1]],
                    [pts[a, 2], pts[b, 2]], c=color)
        ax.plot([], [], c=color, label=label)

    ax.set_xlabel("X")
    ax.set_ylabel("Y")
    ax.set_zlabel("Z")
    ax.set_title("3D Human Skeleton")
    ax.legend()

    canvas = fig.canvas
    canvas.draw()
    width, height = canvas.get_width_height()
    buf = np.frombuffer(canvas.buffer_rgba(), dtype=np.uint8)
    image = buf.reshape(height, width, 4)[:, :, :3].copy()
    plt.close(fig)
    return image


def plot_loss(losses: Sequence[float], save_path: str, title: str) -> str:
    """Loss-curve PNG. [ref: tools/utils.py:169-181]"""
    plt = _pyplot()

    os.makedirs(save_path, exist_ok=True)
    plt.figure()
    plt.plot(np.arange(len(losses)), np.asarray(losses))
    plt.xlabel("Epoch")
    plt.ylabel(title)
    plt.title(f"{title} vs Epoch")
    out = os.path.join(save_path, f"{title}.png")
    plt.savefig(out)
    plt.close()
    return out


def save_gif(frames: List[np.ndarray], path: str,
             duration: int = 40) -> None:
    """Animated GIF from RGB frames. [ref: inference.py:150-152]"""
    from PIL import Image
    imgs = [Image.fromarray(np.asarray(f)) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 optimize=False, duration=duration, loop=0)
