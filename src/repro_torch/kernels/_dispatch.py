"""The JAX package's kernel switches, read by every kernel wrapper.

The JAX wrappers take ``use_pallas`` (force or forbid the Pallas kernel)
and ``interpret`` (run the Pallas kernel in interpret mode), plus block
sizes. The port's wrappers take the same keywords: block sizes are
accepted and ignored (each CUDA kernel picks its own tiles), and
``use_pallas=False`` or ``interpret=True`` is an explicit request for the
plain PyTorch version, which runs and counts no launch. ``None``, the
default, keeps the device dispatch: the kernel on a CUDA tensor (or an
exception), the plain version on a CPU tensor.
"""
from __future__ import annotations

from typing import Optional

__all__ = ["plain_requested"]


def plain_requested(use_pallas: Optional[bool] = None,
                    interpret: Optional[bool] = None) -> bool:
    """True when the caller asks for the plain version."""
    return use_pallas is False or interpret is True
