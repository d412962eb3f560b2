"""Scratch of the kernels whose last block merges a row's partials
(``fused_logpdf.cu``'s ``row_sum``, behind the six one-launch
reductions, and ``categorical_sum``; ``mvn_quad.cu``; ``fused_leapfrog.cu``'s
``leapfrog_kernel``, behind ``fused_leapfrog`` and ``fused_potential_vg``;
``flash_decode``'s last-split merge): float32 partials and int32
last-block counts, kept once per (device, stream). Calls on one stream run
one at a time and each leaves the counts at zero, so the kernels share
them. Nothing here runs at import time.

A CUDA graph (``core/program.py``) records the addresses its kernels were
given, and replays them for its whole life. Two rules keep those addresses
valid, and the capture's counts zero:

* **grow by adding**: an outgrown buffer is moved to ``RETIRED`` and kept
  for the life of the process, never freed, so no address that a graph
  recorded can be handed to another tensor;
* **sized before the capture**: ``reserve(index, stream)``, which a program
  calls just before it captures on ``stream``, grows that stream's scratch
  to the most any call has asked for so far (``HIGH``). The eager first
  call of every signature runs before its capture and so has asked for
  what the capture needs. The buffers are then made, and their counts
  zeroed, eagerly, outside the graph: an allocation inside a capture would
  land in the graph's private pool, and its zeroing would be a memset node
  that runs only when that graph replays. A capture that still needs more
  raises rather than allocate.

Growing alone would leave the second point open, and sizing alone would
free a buffer that an earlier graph recorded on the next growth; so both.
"""
from __future__ import annotations

import torch

__all__ = ["SCRATCH", "RETIRED", "HIGH", "last_block_scratch", "reserve"]

# (device index, stream) -> (partials, counts)
SCRATCH = {}
# buffers SCRATCH outgrew: kept alive, since a graph may have recorded them
RETIRED = []
# the most partials and counts any call has asked for, on any stream
HIGH = {"partials": 4096, "counts": 1024}


def _entry(index: int, stream: int, need: int, rows: int):
    entry = SCRATCH.get((index, stream))
    if entry is not None and entry[0].numel() >= need \
            and entry[1].numel() >= rows:
        return entry
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"kernel scratch must grow during a CUDA graph capture (stream "
            f"{stream}: {need} partials, {rows} counts asked): the capture "
            "stream's scratch is sized by reserve() before the capture")
    if entry is not None:
        RETIRED.append(entry)
    dev = torch.device("cuda", index)
    entry = (torch.empty(max(need, HIGH["partials"]), dtype=torch.float32,
                         device=dev),
             torch.zeros(max(rows, HIGH["counts"]), dtype=torch.int32,
                         device=dev))
    SCRATCH[(index, stream)] = entry
    return entry


def last_block_scratch(index: int, stream: int, rows: int, need: int):
    """Addresses of at least ``need`` float32 partials and ``rows`` zero
    int32 counts on this device and stream."""
    if need > HIGH["partials"]:
        HIGH["partials"] = need
    if rows > HIGH["counts"]:
        HIGH["counts"] = rows
    entry = _entry(index, stream, need, rows)
    return entry[0].data_ptr(), entry[1].data_ptr()


def reserve(index: int, stream: int) -> None:
    """Make this stream's scratch at least ``HIGH``, outside any capture."""
    _entry(index, stream, HIGH["partials"], HIGH["counts"])
