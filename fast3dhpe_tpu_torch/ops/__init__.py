"""Tensor ops of the port and the wrappers of its kernels. Importing the
package registers the kernels' operators (fast3dhpe::soft_argmax,
fast3dhpe::soft_argmax_bwd, fast3dhpe::fused_bottleneck), which an
exported graph (export.py) calls."""

from . import bottleneck, softargmax  # noqa: F401
