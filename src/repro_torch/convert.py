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

``params_from_reference`` carries an LM's weights across: the JAX
package's ``lm.init_params`` pytree, as NumPy arrays
(``jax.tree_util.tree_map(np.asarray, params)``), becomes the port's dict
of tensors, every key and shape checked against the port's own
``init_params`` for the same config. (The JAX package keys its
initialiser on Python's salted ``hash``, so its weights differ from
process to process and cannot be re-derived from a seed.)

``spec_from_reference`` does the same for a compiled separable potential:
the JAX package's ``PotentialSpec`` is plain NumPy data, so its fields
carry across as they are::

    spec_from_reference(s.op, s.c0, s.c1, s.c2, s.c3, s.const, s.dim)
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.core.varinfo import TypedVarInfo
from repro_torch.kernels.fused_leapfrog.spec import PotentialSpec

__all__ = ["layout_signature", "state_from_reference", "spec_from_reference",
           "params_from_reference"]

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


def params_from_reference(tree, cfg, device=None) -> Any:
    """The port's LM parameters from the JAX package's for ``cfg`` (a
    ``repro_torch.nn.lm.ArchConfig``): ``tree`` is the JAX pytree of
    nested dicts and lists with NumPy arrays at the leaves. Each array is
    checked against the shape the port's ``init_params`` gives its key and
    takes that parameter's type (``cfg.dtype``), on ``device`` (the card
    unless the caller asks for the CPU).

    Raises ``ValueError`` naming the first key or shape that differs.
    """
    from repro_torch._device import resolve_device
    from repro_torch.nn.lm import init_params
    return _carry(tree, init_params(cfg, device="meta"),
                  resolve_device(device), "params")


def _carry(ref, like, dev, path: str):
    if isinstance(like, dict):
        if not isinstance(ref, dict) or set(ref) != set(like):
            got = sorted(ref) if isinstance(ref, dict) else type(ref).__name__
            raise ValueError(f"{path}: keys {got}, the port expects "
                             f"{sorted(like)}")
        return {k: _carry(ref[k], v, dev, f"{path}/{k}")
                for k, v in like.items()}
    if isinstance(like, list):
        if not isinstance(ref, (list, tuple)) or len(ref) != len(like):
            raise ValueError(f"{path}: expected a list of {len(like)}, got "
                             f"{type(ref).__name__}")
        return [_carry(r, v, dev, f"{path}/{i}")
                for i, (r, v) in enumerate(zip(ref, like))]
    arr = np.array(ref, dtype=np.float32)  # a writable copy
    if arr.shape != tuple(like.shape):
        raise ValueError(f"{path}: shape {arr.shape}, the port expects "
                         f"{tuple(like.shape)}")
    return torch.as_tensor(arr, device=dev).to(like.dtype)
