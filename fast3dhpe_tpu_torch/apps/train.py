"""2D backbone training CLI. Port of fast3dhpe_tpu/apps/train.py.

    python -m fast3dhpe_tpu_torch.apps.train --config_path configs/mads_2d.yaml
"""

from ..train import loop2d
from ._train_cli import parse_and_run


def main(argv=None):
    """Returns the loop's history."""
    return parse_and_run(loop2d.run, "configs/mads_2d.yaml",
                         "Train PoseResNet (MPII / MADS_2d).", argv)


if __name__ == "__main__":
    main()
