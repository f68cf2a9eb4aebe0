"""The benchmark of fast3dhpe_tpu_torch on an NVIDIA H100 (README.md)."""
