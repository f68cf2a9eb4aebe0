"""Visual check of the 2D pipeline: each sample's warped input with its
gaussian heatmap targets blended over it. Port of
fast3dhpe_tpu/apps/display_data_2d.py.

    python -m fast3dhpe_tpu_torch.apps.display_data_2d --config_path configs/mads_2d.yaml
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..config import load_config
from ..data.loader import Mono2DLoader
from ..ops.warp import IMAGENET_MEAN, IMAGENET_STD


def denormalize(img):
    """Invert the ImageNet normalisation back to uint8."""
    x = np.asarray(img)
    x = (x * np.array(IMAGENET_STD) + np.array(IMAGENET_MEAN)) * 255.0
    return np.clip(x, 0, 255).astype(np.uint8)


def overlay_heatmaps(img_u8, heatmaps):
    """Blend the per-joint heatmap maximum over the image."""
    import cv2
    hm = np.asarray(heatmaps).max(axis=-1)
    hm = cv2.resize(hm, (img_u8.shape[1], img_u8.shape[0]))
    hm = np.clip(hm * 255, 0, 255).astype(np.uint8)
    hm_color = cv2.applyColorMap(hm, cv2.COLORMAP_JET)
    return cv2.addWeighted(img_u8, 0.6, hm_color, 0.4, 0)


def main(argv=None):
    """Returns the number of images written."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_path", type=str,
                        default="configs/mads_2d.yaml")
    parser.add_argument("--image_set", type=str, default="train")
    parser.add_argument("--num_samples", type=int, default=8)
    parser.add_argument("--out_dir", type=str, default="debug_vis")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; an error without a card) or "
                             "cpu")
    args = parser.parse_args(argv)

    config = load_config(args.config_path)
    loader = Mono2DLoader(config, args.image_set, device=args.device)
    os.makedirs(args.out_dir, exist_ok=True)

    import cv2
    written = 0
    try:
        for batch in loader:
            imgs = batch["image"].cpu().numpy()
            targets = batch["target"].cpu().numpy()
            for i in range(int(batch["row_valid"].sum())):
                vis = overlay_heatmaps(denormalize(imgs[i]), targets[i])
                cv2.imwrite(os.path.join(args.out_dir,
                                         f"sample_2d_{written:03d}.jpg"), vis)
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
