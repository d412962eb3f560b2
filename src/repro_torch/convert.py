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

``spec_from_reference`` does the same for a compiled separable potential:
the JAX package's ``PotentialSpec`` is plain NumPy data, so its fields
carry across as they are::

    spec_from_reference(s.op, s.c0, s.c1, s.c2, s.c3, s.const, s.dim)
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.varinfo import TypedVarInfo
from repro_torch.kernels.fused_leapfrog.spec import PotentialSpec

__all__ = ["layout_signature", "state_from_reference", "spec_from_reference"]

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


def spec_from_reference(op, c0, c1, c2, c3, const, dim) -> PotentialSpec:
    """The port's :class:`PotentialSpec` from the NumPy fields of one
    compiled by the JAX package (``repro.core.potential``).

    Raises ``ValueError`` when an array's length is not ``dim``.
    """
    dim = int(dim)
    arrays = {"op": op, "c0": c0, "c1": c1, "c2": c2, "c3": c3}
    for name, a in arrays.items():
        if np.shape(a) != (dim,):
            raise ValueError(f"{name} has shape {np.shape(a)}, expected "
                             f"({dim},)")
    return PotentialSpec(op=np.asarray(op), c0=np.asarray(c0),
                         c1=np.asarray(c1), c2=np.asarray(c2),
                         c3=np.asarray(c3), const=float(const), dim=dim)
