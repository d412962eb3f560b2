"""Scratch of the kernels whose last block merges a row's partials
(``fused_logpdf.cu``'s ``row_sum``, behind the six one-launch
reductions, and ``categorical_sum``; ``fused_leapfrog.cu``'s
``leapfrog_kernel``, behind ``fused_leapfrog`` and
``fused_potential_vg``): float32 partials and int32 last-block counts, kept
once per (device, stream). Calls on one stream run one at a time and each
leaves the counts at zero, so the kernels share them. Nothing here runs at
import time."""
from __future__ import annotations

import torch

__all__ = ["SCRATCH", "last_block_scratch"]

# (device index, stream) -> (partials, counts), grown when a call needs more
SCRATCH = {}


def last_block_scratch(index: int, stream: int, rows: int, need: int):
    """Addresses of at least ``need`` float32 partials and ``rows`` zero
    int32 counts on this device and stream."""
    entry = SCRATCH.get((index, stream))
    if entry is None or entry[0].numel() < need or entry[1].numel() < rows:
        dev = torch.device("cuda", index)
        entry = (torch.empty(max(need, 4096), dtype=torch.float32, device=dev),
                 torch.zeros(max(rows, 1024), dtype=torch.int32, device=dev))
        SCRATCH[(index, stream)] = entry
    return entry[0].data_ptr(), entry[1].data_ptr()
