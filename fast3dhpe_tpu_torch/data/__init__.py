"""Data: index builders, JPEG decode, host loaders, the movement stream,
the device frame cache and the device pipeline. Port of
fast3dhpe_tpu/data/."""

from .mads import (  # noqa: F401
    build_mads_index,
    build_mads_stereo_index,
    MADS_FLIP_PAIRS,
    MADS_PARENT_IDS,
)
from .mpii import build_mpii_index, MPII_FLIP_PAIRS  # noqa: F401
from .loader import Stereo3DLoader, Mono2DLoader, load_data  # noqa: F401
from .stream import LoadMADSData  # noqa: F401
