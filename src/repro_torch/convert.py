"""Carry sampler state across from the JAX package.

A flat unconstrained vector means the same thing in both packages only if
both typed traces lay their sites out identically. ``layout_signature``
reduces a trace's ``FlatLayout`` to plain tuples that either package can
produce without importing the other; ``state_from_reference`` checks the
two signatures and unpacks the vector into the port's trace.

A signature for a JAX-side trace is built the same way from its
``FlatLayout``::

    tuple((s.name, tuple(s.shape), s.unc_offset, s.unc_size)
          for s in tvi.layout.sites)
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.varinfo import TypedVarInfo

__all__ = ["layout_signature", "state_from_reference"]

Signature = Tuple[Tuple[str, Tuple[int, ...], int, int], ...]


def layout_signature(tvi: TypedVarInfo) -> Signature:
    """``(site, shape, unconstrained offset, unconstrained length)`` per
    site, in layout order."""
    return tuple((s.name, tuple(s.shape), s.unc_offset, s.unc_size)
                 for s in tvi.layout.sites)


def state_from_reference(tvi: TypedVarInfo, flat_np,
                         ref_signature: Signature) -> TypedVarInfo:
    """The port's trace at a flat vector taken from the JAX package.

    Parameters
    ----------
    tvi : TypedVarInfo
        The port's trace (linked for an unconstrained vector).
    flat_np : array-like, shape ``(num_flat,)``
        Flat vector exported from the JAX package (e.g. ``np.asarray``).
    ref_signature : tuple
        ``layout_signature`` of the JAX-side trace that produced it.

    Raises ``ValueError`` when the layouts or the length disagree.
    """
    ours = layout_signature(tvi)
    theirs = tuple((str(n), tuple(int(d) for d in shape), int(off), int(size))
                   for n, shape, off, size in ref_signature)
    if ours != theirs:
        raise ValueError(f"flat layouts differ: port {ours} vs reference "
                         f"{theirs}")
    flat = np.asarray(flat_np, dtype=np.float32)
    if flat.shape != (tvi.num_flat,):
        raise ValueError(f"flat vector has shape {flat.shape}, the trace "
                         f"expects ({tvi.num_flat},)")
    return tvi.replace_flat(torch.as_tensor(flat, device=tvi.device))
