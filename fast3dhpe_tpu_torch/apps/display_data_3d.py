"""Visual check of the stereo pipeline's P <- T @ P composition: the
ground-truth joints, projected through the crop-composed projections,
drawn on both warped views. Port of
fast3dhpe_tpu/apps/display_data_3d.py; --show_masks also tints the
occlusion keep-masks' hidden regions red.

    python -m fast3dhpe_tpu_torch.apps.display_data_3d --config_path configs/mads_3d.yaml
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..config import load_config
from ..data.loader import Stereo3DLoader
from ..utils.visualize import MADS_CONNECTIONS
from .display_data_2d import denormalize


def draw_pose(img_u8, pose_2d, weight):
    import cv2
    img = np.ascontiguousarray(img_u8)
    for j, (x, y) in enumerate(np.asarray(pose_2d)):
        color = (0, 255, 0) if weight[j] > 0 else (0, 0, 255)
        if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
            cv2.circle(img, (int(x), int(y)), 3, color, -1)
    for a, b in MADS_CONNECTIONS:
        pa, pb = pose_2d[a], pose_2d[b]
        if weight[a] > 0 and weight[b] > 0:
            cv2.line(img, (int(pa[0]), int(pa[1])),
                     (int(pb[0]), int(pb[1])), (255, 200, 0), 1)
    return img


def overlay_keep_mask(img_u8, keep_mask):
    """Tint the occluded (keep == False) region red."""
    img = np.ascontiguousarray(img_u8).astype(np.float32)
    hidden = ~np.asarray(keep_mask, bool)
    tint = np.array([0.0, 0.0, 255.0])  # BGR red
    img[hidden] = 0.45 * img[hidden] + 0.55 * tint
    return img.astype(np.uint8)


def main(argv=None):
    """Returns the number of images written."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_path", type=str,
                        default="configs/mads_3d.yaml")
    parser.add_argument("--image_set", type=str, default="train")
    parser.add_argument("--num_samples", type=int, default=8)
    parser.add_argument("--out_dir", type=str, default="debug_vis")
    parser.add_argument("--show_masks", action="store_true",
                        help="overlay the occlusion keep-masks (red = "
                             "hidden) with per-joint visibility coloring")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; an error without a card) or "
                             "cpu")
    args = parser.parse_args(argv)

    config = load_config(args.config_path)
    loader = Stereo3DLoader(config, args.image_set,
                            return_masks=args.show_masks, device=args.device)
    os.makedirs(args.out_dir, exist_ok=True)

    import cv2
    written = 0
    try:
        for batch in loader:
            imgs = batch["image"].cpu().numpy()          # (B, 2, H, W, 3)
            t2d = batch["target_2d"].cpu().numpy()       # (B, 2, J, 2)
            w = batch["target_weight"].cpu().numpy()
            masks = (batch["keep_mask"].cpu().numpy()
                     if args.show_masks else None)
            for i in range(int(batch["row_valid"].sum())):
                views = []
                for v in range(2):
                    img = denormalize(imgs[i, v])
                    if masks is not None:
                        img = overlay_keep_mask(img, masks[i, v])
                    views.append(draw_pose(img, t2d[i, v], w[i]))
                cv2.imwrite(os.path.join(args.out_dir,
                                         f"sample_3d_{written:03d}.jpg"),
                            np.concatenate(views, axis=1))
                written += 1
                if written >= args.num_samples:
                    break
            if written >= args.num_samples:
                break
    finally:
        loader.close()
    print(f"Wrote {written} overlays to {args.out_dir}")
    return written


if __name__ == "__main__":
    main()
