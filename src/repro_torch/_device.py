"""Device selection shared by every entry point of the port.

Entry points run on the card unless the caller asks for the CPU: a
``device`` of ``None`` means ``"cuda"``, and asking for CUDA on a machine
without it raises instead of quietly running on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """Return the ``torch.device`` an entry point runs on.

    Also switches TF32 off for matmuls and cuDNN: the log-densities are
    held to 1e-5 in float32, which TF32's ~3 decimal digits cannot meet
    (``logreg``'s ``X @ w`` is a 10,000 x 100 product).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
