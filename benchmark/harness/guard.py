"""The import guard: the benchmark measures the PyTorch port alone, so no
module of JAX or of the JAX package may be loaded in its process. Names
are compared by their top-level part, whole: `fast3dhpe_tpu_torch` is not
`fast3dhpe_tpu`."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "fast3dhpe_tpu")


def forbidden_modules(modules=None):
    """The forbidden top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names}
                  & set(FORBIDDEN))


def check():
    """Raise naming every forbidden module that is loaded."""
    found = forbidden_modules()
    if found:
        raise ImportError(f"the benchmark's process has loaded {found}: it "
                          f"measures the PyTorch port alone")
