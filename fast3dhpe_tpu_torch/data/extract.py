"""MADS offline ETL: raw stereo videos and .mat calibration -> the
extracted JPEG/JSON tree that the index builders read. Port of
fast3dhpe_tpu/data/extract.py (:1-214).

A one-time step on a host with scipy and cv2 (video decode, undistortion,
JPEG writing), never on the GPU. Carried over from the reference:

  - the LEFT camera's intrinsics in the depth calibration are changed by
    the rectification, so the RIGHT camera's K serves both cameras;
  - the left rotation vector is negated before Rodrigues;
  - stereo rectification applies precomputed sparse bilinear index maps
    (ind_1..4 / a1..4) to the Fortran-order flattened image, all channels
    in one gather;
  - the FIRST video of each movement goes to valid/, the rest to train/.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict

import numpy as np

from ..geometry.camera import rodrigues

MOVEMENTS = ("HipHop", "Jazz", "Kata", "Sports", "Taichi")
RECTIFY_FILL = 144


def parse_bouguet_calibs(calibs_left_path: str,
                         calibs_right_path: str) -> Dict:
    """Parse Bouguet-toolbox calibration .mats into K/R/T/dist per camera."""
    import scipy.io

    left = scipy.io.loadmat(calibs_left_path)
    right = scipy.io.loadmat(calibs_right_path)

    fc, cc = right["fc"], right["cc"]
    alpha_c, kc = right["alpha_c"], right["kc"]
    K = np.array([
        [fc[0][0], alpha_c[0][0] * fc[0][0], cc[0][0]],
        [0.0, fc[1][0], cc[1][0]],
        [0.0, 0.0, 1.0],
    ], dtype=np.float32)

    rvec_left = -left["om"]                      # sign fix for left camera
    tvec_left = left["T"]
    rvec_right = right["om_ext"]
    tvec_right = right["T_ext"]

    def cam(rvec, tvec):
        return {
            "intrinsics": K,
            "rotation": rodrigues(np.ravel(rvec)).numpy().astype(
                np.float64),
            "translation": np.asarray(tvec).reshape(3, 1),
            "distortion_coeffs": kc,
        }

    return {"left": cam(rvec_left, tvec_left),
            "right": cam(rvec_right, tvec_right)}


def parse_rectify_maps(rectified_path: str, camera: str) -> Dict:
    """Load the precomputed bilinear rectification maps (1-based -> 0-based
    for the source indices)."""
    import scipy.io

    if camera not in ("left", "right"):
        raise ValueError(f"camera must be 'left' or 'right', not {camera!r}")
    data = scipy.io.loadmat(rectified_path)
    return {
        "ind_new": data[f"ind_new_{camera}"][:, 0],
        **{f"ind_{k}": data[f"ind_{k}_{camera}"][0] - 1 for k in range(1, 5)},
        **{f"a{k}": data[f"a{k}_{camera}"][0] for k in range(1, 5)},
    }


def rectify_image(img: np.ndarray, maps: Dict) -> np.ndarray:
    """Apply the sparse bilinear rectification maps.

    The maps address pixels of the FORTRAN-order flattened image; all
    channels are gathered at once (the reference loops channels).
    """
    h, w, c = img.shape
    flat = img.reshape((-1, c), order="F")
    out = np.full_like(flat, RECTIFY_FILL)
    acc = (maps["a1"][:, None] * flat[maps["ind_1"]]
           + maps["a2"][:, None] * flat[maps["ind_2"]]
           + maps["a3"][:, None] * flat[maps["ind_3"]]
           + maps["a4"][:, None] * flat[maps["ind_4"]])
    out[maps["ind_new"]] = acc.astype(np.uint8)
    return out.reshape((h, w, c), order="F").copy()


def undistort_image(img, K, dist_coeffs, new_K=None):
    """cv2.undistort with new_K = K unless given."""
    import cv2
    if new_K is None:
        new_K = np.asarray(K).copy()
    return cv2.undistort(img, np.asarray(K), np.asarray(dist_coeffs), None,
                         new_K)


class MADSExtractor:
    def __init__(self, calibs_left_path, calibs_right_path,
                 rectified_left_path, rectified_right_path,
                 undistort: bool = False, rectify_stereo: bool = False):
        self.calibs = parse_bouguet_calibs(calibs_left_path,
                                           calibs_right_path)
        self.rectify = {
            "left": parse_rectify_maps(rectified_left_path, "left"),
            "right": parse_rectify_maps(rectified_right_path, "right"),
        }
        self.undistort = undistort
        self.rectify_stereo = rectify_stereo

    def _process_frame(self, frame: np.ndarray, camera: str) -> np.ndarray:
        if self.undistort:
            frame = undistort_image(
                frame, self.calibs[camera]["intrinsics"],
                self.calibs[camera]["distortion_coeffs"])
        if self.rectify_stereo:
            frame = rectify_image(frame, self.rectify[camera])
        return frame

    def extract_video(self, video_path: str, camera: str,
                      output_dir: str) -> int:
        """Video -> per-frame JPGs; returns frame count."""
        import cv2
        out_path = os.path.join(output_dir, camera)
        os.makedirs(out_path, exist_ok=True)
        cap = cv2.VideoCapture(video_path)
        count = 0
        while True:
            ret, frame = cap.read()
            if not ret:
                break
            frame = self._process_frame(frame, camera)
            cv2.imwrite(os.path.join(out_path,
                                     f"{camera}_{count:04d}.jpg"), frame)
            count += 1
        cap.release()
        return count

    def save_gt_pose(self, gt_pose_path: str, output_dir: str) -> int:
        """GTpose2 .mat -> per-frame JSON with calibration info."""
        import scipy.io
        out_path = os.path.join(output_dir, "pose")
        os.makedirs(out_path, exist_ok=True)
        gt_pose = scipy.io.loadmat(gt_pose_path)["GTpose2"][0]

        calibs = {}
        for camera in ("left", "right"):
            c = self.calibs[camera]
            calibs[f"cam_{camera}"] = {
                "intrinsics": np.asarray(c["intrinsics"]).tolist(),
                "rotation": np.asarray(c["rotation"]).tolist(),
                "translation": np.asarray(c["translation"]).tolist(),
                "distortion_coeffs":
                    np.asarray(c["distortion_coeffs"]).tolist(),
            }
        for i, pose in enumerate(gt_pose):
            with open(os.path.join(out_path, f"gt_pose_{i:04d}.json"),
                      "w") as f:
                json.dump({"calibs_info": calibs,
                           "pose_3d": pose.tolist()},
                          f, indent=4, sort_keys=True)
        return len(gt_pose)

    def process(self, video_left_path, video_right_path, gt_pose_path,
                output_dir):
        os.makedirs(output_dir, exist_ok=True)
        self.save_gt_pose(gt_pose_path, output_dir)
        self.extract_video(video_left_path, "left", output_dir)
        self.extract_video(video_right_path, "right", output_dir)


def extract_all(depth_data_path: str, multiview_data_path: str,
                output_path: str, undistort: bool = False,
                rectify_stereo: bool = False,
                movements=MOVEMENTS) -> None:
    """Full ETL over all movements; first video per movement -> valid/."""
    for movement in movements:
        calibs_left = os.path.join(depth_data_path, movement,
                                   "Calib_C0_left.mat")
        calibs_right = os.path.join(multiview_data_path, movement,
                                    "Calib_Cam0.mat")
        rect_left = os.path.join(depth_data_path, movement,
                                 "rect_calib_left.mat")
        rect_right = os.path.join(depth_data_path, movement,
                                  "rect_calib_right.mat")
        videos_left = sorted(glob.glob(os.path.join(
            depth_data_path, movement, "*_Left.avi")))
        videos_right = sorted(glob.glob(os.path.join(
            depth_data_path, movement, "*_Right.avi")))
        gt_poses = sorted(glob.glob(os.path.join(
            depth_data_path, movement, "*_GT.mat")))
        if not len(videos_left) == len(videos_right) == len(gt_poses):
            raise ValueError("Number of videos and ground truth pose must "
                             "be the same")

        extractor = MADSExtractor(calibs_left, calibs_right, rect_left,
                                  rect_right, undistort, rectify_stereo)
        for i, (vl, vr, gt) in enumerate(zip(videos_left, videos_right,
                                             gt_poses)):
            split = "valid" if i == 0 else "train"
            out_dir = os.path.join(output_path, split, movement, str(i))
            print(f"Processing {movement} {i + 1}/{len(videos_left)} "
                  f"-> {out_dir}")
            extractor.process(vl, vr, gt, out_dir)
