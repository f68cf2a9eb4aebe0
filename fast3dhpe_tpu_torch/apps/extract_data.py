"""MADS ETL command line: python -m fast3dhpe_tpu_torch.apps.extract_data.
Port of fast3dhpe_tpu/apps/extract_data.py."""

import argparse

from ..data.extract import extract_all


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--depth_data_path", type=str,
                        default="data/MADS/MADS_depth/depth_data",
                        help="path storing stereo videos and GT pose")
    parser.add_argument("--multiview_data_path", type=str,
                        default="data/MADS/MADS_multiview/multi_view_data",
                        help="path storing multiview calibration (right "
                             "camera)")
    parser.add_argument("--output_path", type=str,
                        default="data/MADS_extract")
    parser.add_argument("--undistort", action="store_true")
    parser.add_argument("--rectify_stereo", action="store_true")
    args = parser.parse_args()
    print(args)

    extract_all(args.depth_data_path, args.multiview_data_path,
                args.output_path, args.undistort, args.rectify_stereo)


if __name__ == "__main__":
    main()
