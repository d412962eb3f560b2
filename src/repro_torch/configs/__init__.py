"""Architecture + shape registry, as ``repro.configs``.

One module per architecture, each with its public-literature config as
``CONFIG`` and a reduced same-family ``SMOKE`` config, as data (torch
dtypes). ``get_config`` resolves the hyphenated ids. ``input_specs`` (the
JAX package's allocation-free stand-ins for the dry-run) waits with
``launch/dryrun`` (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple

from repro_torch.nn.lm import ArchConfig

__all__ = ["ARCH_NAMES", "SHAPES", "ShapeSpec", "get_config",
           "get_smoke_config", "supports_shape", "cells", "skip_reason"]

ARCH_NAMES = (
    "deepseek-v2-lite-16b",
    "granite-moe-1b-a400m",
    "minitron-4b",
    "smollm-360m",
    "granite-8b",
    "gemma2-27b",
    "recurrentgemma-9b",
    "internvl2-26b",
    "mamba2-1.3b",
    "seamless-m4t-large-v2",
)

_MODULE_OF = {name: name.replace("-", "_").replace(".", "_")
              for name in ARCH_NAMES}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def _load(name: str):
    if name not in _MODULE_OF:
        raise KeyError(f"unknown architecture '{name}'; known: {ARCH_NAMES}")
    return importlib.import_module(f"repro_torch.configs.{_MODULE_OF[name]}")


def get_config(name: str) -> ArchConfig:
    return _load(name).CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    return _load(name).SMOKE


def _cache_is_bounded(cfg: ArchConfig) -> bool:
    """True iff decode-state memory is O(1) in sequence length: every block
    type keeps constant-size state (ssd/rglru) or a ring-buffer window."""
    for btype in cfg.layer_pattern:
        if btype in ("ssd", "rglru"):
            continue
        if btype == "local" and cfg.window is not None:
            continue
        return False
    return True


def skip_reason(arch: str, shape: str) -> Optional[str]:
    cfg = get_config(arch)
    if SHAPES[shape].name == "long_500k" and not _cache_is_bounded(cfg):
        return ("unbounded full-attention KV cache at 524288 tokens "
                "(needs sub-quadratic stack; see DESIGN.md)")
    return None


def supports_shape(arch: str, shape: str) -> bool:
    return skip_reason(arch, shape) is None


def cells(include_skipped: bool = False) -> List[Tuple[str, str]]:
    return [(a, s) for a in ARCH_NAMES for s in SHAPES
            if include_skipped or supports_shape(a, s)]
