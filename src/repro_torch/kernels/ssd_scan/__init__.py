"""Mamba-2 chunked SSD scan: a hand-written CUDA kernel for Hopper
(``csrc/ssd_scan.cu``) beside its plain PyTorch version (``ref.py``)."""
from repro_torch.kernels.ssd_scan.ops import (  # noqa: F401
    LAUNCHES, reset_launch_counts, ssd_scan)
