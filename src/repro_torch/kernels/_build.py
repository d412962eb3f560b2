"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``.cu`` source under a ``csrc/`` directory of the package is compiled
on first use into a shared library with a plain C interface, for
``sm_90a`` (Hopper). Libraries go into ``build/repro_torch_kernels/`` at
the root of the checkout (listed in ``.gitignore``), keyed by a hash of the
source, the headers it includes by a quoted path (``kernels/csrc/tf32.cuh``)
and the compiler flags, so an edited source or header rebuilds and an
unchanged one is loaded as it is. Nothing here runs at import time.

A missing ``nvcc``, a failed build or a failed launch raises
:class:`KernelError`, so callers can tell a kernel's failure from their
own.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

__all__ = ["NVCC_FLAGS", "BUILD_DIR", "KernelError", "load_library",
           "find_nvcc", "library_path", "source_files"]

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
_PACKAGE = Path(__file__).resolve().parents[1]
BUILD_DIR = _PACKAGE.parents[1] / "build" / "repro_torch_kernels"

_DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's default prefix
_LOADED: Dict[Path, ctypes.CDLL] = {}
_QUOTED_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


class KernelError(RuntimeError):
    """A CUDA kernel could not be built, loaded or launched."""


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default prefix. Raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    cands.append(_DEFAULT_NVCC)
    for c in cands:
        if c.is_file():
            return str(c)
    raise KernelError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                      "the CUDA kernels cannot be built")


def source_files(source: Path) -> List[Path]:
    """``source`` and every file it includes by a quoted path (read
    relative to the including file, as ``nvcc`` does), each once, the
    source first."""
    files, todo = [], [Path(source).resolve()]
    while todo:
        f = todo.pop()
        if f not in files:
            files.append(f)
            todo += [(f.parent / m.decode()).resolve()
                     for m in reversed(_QUOTED_INCLUDE.findall(f.read_bytes()))]
    return files


def library_path(source: Path) -> Path:
    """Where the library for ``source`` lives: keyed by a hash of the
    source's text, its included headers' (``source_files``) and the
    flags."""
    digest = hashlib.sha256(b"".join(f.read_bytes()
                                     for f in source_files(source))
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{digest}" / f"lib{source.stem}.so"


def load_library(source: Path) -> ctypes.CDLL:
    """Build (if needed) and load the library for one source, once per
    process."""
    lib = library_path(Path(source))
    if not lib.is_file():
        nvcc = find_nvcc()
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise KernelError(f"nvcc failed for {Path(source).name} (exit "
                              f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a reader never sees half a library
    if lib not in _LOADED:
        try:
            _LOADED[lib] = ctypes.CDLL(str(lib))
        except OSError as e:
            raise KernelError(f"cannot load {lib}: {e}") from e
    return _LOADED[lib]
