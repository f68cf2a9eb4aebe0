"""Export a trained CDRNet to a serving artifact (torch.export). Port of
fast3dhpe_tpu/apps/export.py.

    python -m fast3dhpe_tpu_torch.apps.export \\
        --config_path configs/mads_3d.yaml --batch_size 64 --out cdrnet101.pt2

The artifact carries preprocessing, forward and weights; load it with
fast3dhpe_tpu_torch.export.load_serving, which needs the port's operators
(fast3dhpe_tpu_torch.ops) but no checkpoint. `--device` (cuda by default,
an error without a card) takes the place of the JAX app's `--platforms`:
an artifact serves either device (export.py). The model exports unfused,
as the JAX app exports it.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    """Returns (path, bytes) of the artifact written."""
    parser = argparse.ArgumentParser(
        description="Export CDRNet's serving function.")
    parser.add_argument("--config_path", type=str,
                        default="configs/mads_3d.yaml")
    parser.add_argument("--weights_root", type=str, default="weights")
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--device", type=str, default="cuda",
                        help="device to trace on, cuda (default; an error "
                             "without a card) or cpu; the artifact serves "
                             "either")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute in the exported graph")
    parser.add_argument("--out", type=str, default=None,
                        help="output path (default <MODEL.NAME>.pt2)")
    parser.add_argument("--int8_pack", type=str, default=None,
                        help="export the int8 PTQ path from this .npz pack "
                             "(apps.inference --int8_pack writes one) "
                             "instead of the fp checkpoint")
    args = parser.parse_args(argv)

    import torch

    from ..config import load_config
    from ..export import export_cdrnet, export_cdrnet_int8, save_exported
    from ..models.cdrnet import CDRNet
    from ..train.checkpoint import load_variables

    config = load_config(args.config_path)
    size = tuple(config.MODEL.IMAGE_SIZE)
    if args.int8_pack:
        from ..models.quantized import load_pack
        exported = export_cdrnet_int8(
            load_pack(args.int8_pack), batch_size=args.batch_size,
            image_size=size, dlt_method=config.MODEL.EXTRA.DLT_METHOD,
            device=args.device)
    else:
        model = CDRNet.from_config(
            config, dtype=torch.bfloat16 if args.bf16 else torch.float32)
        exported = export_cdrnet(
            model, load_variables(os.path.join(args.weights_root,
                                               config.MODEL.NAME)),
            batch_size=args.batch_size, image_size=size, device=args.device)
    out = args.out or f"{config.MODEL.NAME}.pt2"
    size_bytes = save_exported(exported, out)
    print(f"Wrote {out} ({size_bytes / 1e6:.1f} MB, traced on "
          f"{args.device}, batch={args.batch_size})")
    return out, size_bytes


if __name__ == "__main__":
    main()
