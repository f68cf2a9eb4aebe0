"""CDRNet stereo training CLI. Port of fast3dhpe_tpu/apps/train_cdr.py.

    python -m fast3dhpe_tpu_torch.apps.train_cdr --config_path configs/mads_3d.yaml
"""

from ..train import loop_cdr
from ._train_cli import parse_and_run


def main(argv=None):
    """Returns the loop's history."""
    return parse_and_run(loop_cdr.run, "configs/mads_3d.yaml",
                         "Train CDRNet (MADS_3d).", argv)


if __name__ == "__main__":
    main()
