"""Plain PyTorch version of the SSD scan kernel.

``repro_torch.nn.ssm.ssd_chunked_ref`` is the model's own chunked scan in
plain torch; the kernel never calls it, and the tests hold the two
together.
"""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.nn.ssm import ssd_chunked_ref

__all__ = ["ssd_scan_ref"]


def ssd_scan_ref(x, dt, A, B, C, *, chunk: int = 128):
    """x: (b,s,h,p); dt: (b,s,h); A: (h,); B, C: (b,s,g,n) -> y (b,s,h,p).
    The sequence is padded to a chunk multiple with dt = 0."""
    s = x.shape[1]
    s_p = -(-s // chunk) * chunk
    if s_p != s:
        pad = (0, 0, 0, 0, 0, s_p - s)
        x, B, C = F.pad(x, pad), F.pad(B, pad), F.pad(C, pad)
        dt = F.pad(dt, (0, 0, 0, s_p - s))
    return ssd_chunked_ref(x, dt, A, B, C, chunk=chunk)[:, :s]
