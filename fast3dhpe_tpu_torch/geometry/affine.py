"""Affine crop transforms and joint flipping, on the host in numpy. A copy
of fast3dhpe_tpu/geometry/affine.py (the port imports nothing of the JAX
package): the same numpy arithmetic, so the same matrices bit for bit.

cv2.getAffineTransform is replaced by an explicit 6x6 solve, so nothing
here needs OpenCV. The image resampling runs on the device
(ops/warp.py affine_warp).
"""

from __future__ import annotations

import numpy as np


def _get_dir(src_point, rot_rad):
    """Rotate a 2D offset by rot_rad."""
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return np.array([
        src_point[0] * cs - src_point[1] * sn,
        src_point[0] * sn + src_point[1] * cs,
    ], dtype=np.float32)


def _get_3rd_point(a, b):
    """Third point completing an orthogonal triangle."""
    direct = a - b
    return b + np.array([-direct[1], direct[0]], dtype=np.float32)


def _solve_affine(src, dst):
    """The 2x3 affine mapping 3 src points onto 3 dst points, by a 6x6
    linear solve in float64."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    A = np.zeros((6, 6))
    b = np.zeros(6)
    for i in range(3):
        A[2 * i, 0:2] = src[i]
        A[2 * i, 2] = 1.0
        A[2 * i + 1, 3:5] = src[i]
        A[2 * i + 1, 5] = 1.0
        b[2 * i] = dst[i, 0]
        b[2 * i + 1] = dst[i, 1]
    x = np.linalg.solve(A, b)
    return x.reshape(2, 3).astype(np.float64)


def get_affine_transform(center, scale, rot, origin_size, output_size,
                         shift=(0.0, 0.0), inv=False):
    """The 2x3 crop/scale/rotate transform: maps the square of side
    ``scale * origin_size`` centred at ``center`` (rotated by ``rot``
    degrees) onto the ``output_size`` (W, H) image; ``inv`` gives the
    reverse map."""
    center = np.asarray(center, np.float32)
    shift = np.asarray(shift, np.float32)
    if not isinstance(scale, (np.ndarray, list, tuple)):
        scale = np.array([scale, scale], dtype=np.float32)
    scale = np.asarray(scale, np.float32)

    scale_tmp = scale * origin_size
    src_w = scale_tmp[0]
    dst_w, dst_h = output_size[0], output_size[1]

    rot_rad = np.pi * rot / 180.0
    src_dir = _get_dir([0.0, src_w * -0.5], rot_rad)
    dst_dir = np.array([0.0, dst_w * -0.5], np.float32)

    src = np.zeros((3, 2), dtype=np.float32)
    dst = np.zeros((3, 2), dtype=np.float32)
    src[0, :] = center + scale_tmp * shift
    src[1, :] = center + src_dir + scale_tmp * shift
    dst[0, :] = [dst_w * 0.5, dst_h * 0.5]
    dst[1, :] = np.array([dst_w * 0.5, dst_h * 0.5], np.float32) + dst_dir
    src[2, :] = _get_3rd_point(src[0, :], src[1, :])
    dst[2, :] = _get_3rd_point(dst[0, :], dst[1, :])

    if inv:
        return _solve_affine(dst, src)
    return _solve_affine(src, dst)


def affine_transform_points(points, trans):
    """Apply a 2x3 affine to (N, 2) points, in float64."""
    points = np.asarray(points, np.float64)
    homo = np.concatenate([points, np.ones((points.shape[0], 1))], axis=1)
    return homo @ np.asarray(trans).T


def fliplr_joints(joints, joints_vis, width, matched_parts):
    """Flip joints horizontally and swap the left/right pairs. Returns
    (joints * joints_vis, joints_vis): invisible joints come back zeroed,
    as the reference returns them."""
    joints = np.array(joints, copy=True)
    joints_vis = np.array(joints_vis, copy=True)
    joints[:, 0] = width - joints[:, 0] - 1
    for a, b in matched_parts:
        joints[[a, b]] = joints[[b, a]]
        joints_vis[[a, b]] = joints_vis[[b, a]]
    return joints * joints_vis, joints_vis


def compose_projection_with_affine(P, trans):
    """Fold a 2x3 image-space affine into a 4x4 projection matrix:
    P <- T @ P with T = eye(4), T[:2, :3] = trans."""
    T = np.eye(4)
    T[:2, :3] = trans
    return T @ np.asarray(P)


def update_intrinsics_with_affine(K, trans):
    """Fold a 2x3 image-space affine into a 3x3 intrinsic matrix:
    K <- [[trans @ K]; [0, 0, 1]]."""
    return np.vstack([np.asarray(trans) @ np.asarray(K),
                      np.array([0.0, 0.0, 1.0])])
