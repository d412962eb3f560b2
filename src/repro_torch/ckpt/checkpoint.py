"""Atomic, keep-N checkpointing for trees of tensors and arrays, as
``repro.ckpt.checkpoint``.

Layout:  <dir>/step_<N>/
            manifest.json       {step, leaves: [{path, shape, dtype, file}]}
            shard_<i>.npz       numpy arrays (possibly several leaves each)
            COMMITTED           zero-byte marker written LAST

A tree is nested dicts, tuples, lists, named tuples and other nodes
registered with ``torch.utils._pytree`` (``bayes_lm.TrainState``) whose
leaves are tensors, NumPy arrays or numbers; ``None`` holds no leaf.
Leaves are ordered and named as ``jax.tree_util`` names them (dict keys
sorted; ``['key']``, ``[i]`` and ``.field`` path steps, and ``[<flat index
i>]`` for a registered node, which ``jax`` registers without keys), so a
manifest reads the same as one ``repro`` wrote. A bfloat16 tensor is
stored as its bits (int16) under the dtype name ``bfloat16`` and restored
bit for bit.

Guarantees:
* **Atomicity** — everything is written into ``step_<N>.tmp`` and renamed;
  the COMMITTED marker is written after the rename + fsync. ``restore``
  and ``latest_step`` ignore directories without the marker, so a
  preemption mid-save can never corrupt the restore path.
* **Device-agnostic** — leaves are stored as host arrays, so a checkpoint
  restores onto any device: ``restore(target=)`` puts a tensor leaf on
  its prototype's device.
* **keep-N retention** — older committed steps beyond ``keep`` are pruned
  after a successful commit (never before).
* **Async** — ``AsyncCheckpointer`` copies every leaf to host memory
  synchronously (one copy a leaf, a CPU tensor's too, since a training
  step rewrites its state in place) and writes in a background thread,
  overlapping the next step's compute; ``wait()`` joins before the next
  save or on preemption.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import SUPPORTED_NODES

__all__ = ["save", "restore", "latest_step", "read_meta", "committed_steps",
           "AsyncCheckpointer"]

_MARKER = "COMMITTED"
_LEAVES_PER_SHARD = 64


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in ``jax.tree_util.tree_flatten_with_path``'s
    order, each path as ``jax.tree_util.keystr`` writes it."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_paths(tree[k], f"{prefix}[{k!r}]")
        return out
    if _is_namedtuple(tree):
        out = []
        for name, v in zip(tree._fields, tree):
            out += _flatten_with_paths(v, f"{prefix}.{name}")
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten_with_paths(v, f"{prefix}[{i}]")
        return out
    node = SUPPORTED_NODES.get(type(tree))
    if node is not None:
        out = []
        for i, v in enumerate(node.flatten_fn(tree)[0]):
            out += _flatten_with_paths(v, f"{prefix}[<flat index {i}>]")
        return out
    return [(prefix, tree)]


def _unflatten(proto, leaves):
    """``proto``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if proto is None:
        return None
    if isinstance(proto, dict):
        # leaves come in sorted key order; the dict keeps proto's order
        got = {k: _unflatten(proto[k], leaves) for k in sorted(proto)}
        return {k: got[k] for k in proto}
    if _is_namedtuple(proto):
        return type(proto)(*(_unflatten(v, leaves) for v in proto))
    if isinstance(proto, (tuple, list)):
        return type(proto)(_unflatten(v, leaves) for v in proto)
    node = SUPPORTED_NODES.get(type(proto))
    if node is not None:
        children, context = node.flatten_fn(proto)
        return node.unflatten_fn([_unflatten(v, leaves) for v in children],
                                 context)
    return next(leaves)


def _host(leaf):
    """One leaf on the host, a copy of its own: a tensor as a CPU tensor
    (a device tensor: one synchronised copy), anything else as an array."""
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu", copy=True)
    return np.asarray(leaf)


def _as_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(the array written, the dtype name the manifest records): NumPy has
    no bfloat16, so a bfloat16 tensor is written as its int16 bits."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_entry(arr: np.ndarray, dtype: str):
    """A stored array as it was saved: bfloat16 bits as a CPU tensor."""
    if dtype == "bfloat16" and arr.dtype == np.int16:
        return torch.from_numpy(np.array(arr)).view(torch.bfloat16)
    return arr


def save(directory: str, step: int, tree, keep: Optional[int] = None,
         meta: Optional[Dict[str, Any]] = None,
         hooks: Optional[Dict[str, Any]] = None) -> str:
    """Write ``tree`` at ``step``; returns the committed directory.

    ``meta`` (JSON-serialisable dict) is stored in the manifest and read
    back with :func:`read_meta` — callers use it to refuse resuming from
    a checkpoint written by a differently-configured run.

    ``hooks`` is a fault-injection seam (``runtime.faultinject``): the
    ``"before_rename"`` / ``"before_commit"`` callables run just before
    the atomic rename and just before the COMMITTED marker. A hook that
    raises simulates a writer killed at that instant, leaving the
    on-disk state a crash would leave.
    """
    hooks = hooks or {}
    os.makedirs(directory, exist_ok=True)
    final = _step_dir(directory, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    leaves = _flatten_with_paths(tree)
    manifest = {"step": step, "leaves": []}
    if meta is not None:
        manifest["meta"] = meta
    for si in range(0, len(leaves), _LEAVES_PER_SHARD):
        chunk = leaves[si:si + _LEAVES_PER_SHARD]
        fname = f"shard_{si // _LEAVES_PER_SHARD:05d}.npz"
        arrays = {}
        for j, (path, leaf) in enumerate(chunk):
            arr, dtype = _as_numpy(leaf)
            key = f"a{j}"
            arrays[key] = arr
            manifest["leaves"].append({
                "path": path, "file": fname, "key": key,
                "shape": list(arr.shape), "dtype": dtype,
            })
        np.savez(os.path.join(tmp, fname), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())

    if "before_rename" in hooks:
        hooks["before_rename"](tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    if "before_commit" in hooks:
        hooks["before_commit"](final)
    # commit marker LAST: restore ignores uncommitted step dirs
    with open(os.path.join(final, _MARKER), "w") as f:
        f.flush()
        os.fsync(f.fileno())

    if keep is not None:
        for s in committed_steps(directory)[:-keep]:
            shutil.rmtree(_step_dir(directory, s), ignore_errors=True)
    return final


def committed_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, _MARKER)):
                out.append(int(name[len("step_"):]))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = committed_steps(directory)
    return steps[-1] if steps else None


def _committed_dir(directory: str, step: Optional[int]) -> Tuple[int, str]:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    d = _step_dir(directory, step)
    if not os.path.exists(os.path.join(d, _MARKER)):
        raise FileNotFoundError(f"checkpoint step {step} is not committed")
    return step, d


def read_meta(directory: str, step: Optional[int] = None) -> Dict[str, Any]:
    """Return the ``meta`` dict stored with a committed step ({} if none)."""
    _, d = _committed_dir(directory, step)
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f).get("meta", {})


def restore(directory: str, step: Optional[int] = None,
            target: Any = None) -> Tuple[int, Any]:
    """Load (step, tree). With ``target`` (a tree prototype), leaves are
    returned in target's structure and validated against its shapes; a
    tensor prototype gives a tensor of its dtype on its device, any other
    leaf a NumPy array (of the prototype's dtype where it has one).
    Without ``target`` a flat {path: array} dict is returned (a bfloat16
    leaf as a CPU tensor)."""
    step, d = _committed_dir(directory, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    files: Dict[str, Any] = {}
    by_path: Dict[str, np.ndarray] = {}
    for entry in manifest["leaves"]:
        if entry["file"] not in files:
            files[entry["file"]] = np.load(os.path.join(d, entry["file"]))
        by_path[entry["path"]] = _from_entry(
            files[entry["file"]][entry["key"]], entry["dtype"])

    if target is None:
        return step, by_path
    leaves = []
    for key, proto in _flatten_with_paths(target):
        if key not in by_path:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = by_path[key]
        want_shape = (tuple(proto.shape) if torch.is_tensor(proto)
                      else tuple(np.shape(proto)))
        if tuple(arr.shape) != want_shape:
            raise ValueError(
                f"leaf {key}: checkpoint shape {arr.shape} != {want_shape}")
        if torch.is_tensor(proto):
            t = arr if torch.is_tensor(arr) else torch.from_numpy(
                np.array(arr))
            leaves.append(t.to(device=proto.device, dtype=proto.dtype))
        else:
            if torch.is_tensor(arr):
                arr = arr.float().numpy()
            leaves.append(arr.astype(np.asarray(proto).dtype)
                          if hasattr(proto, "dtype") else arr)
    return step, _unflatten(target, iter(leaves))


class AsyncCheckpointer:
    """Overlap checkpoint IO with compute: snapshot now, write later.
    ``write_s`` sums the seconds its writer threads took."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self.write_s = 0.0
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree,
             meta: Optional[Dict[str, Any]] = None) -> None:
        self.wait()
        # every leaf to the host now (a consistent snapshot: the caller may
        # overwrite its device buffers as soon as this returns); the files
        # are written in the thread
        host_tree = _unflatten(tree, iter(
            [_host(leaf) for _, leaf in _flatten_with_paths(tree)]))

        def _write():
            t0 = time.perf_counter()
            try:
                save(self.directory, step, host_tree, keep=self.keep,
                     meta=meta)
            except BaseException as e:  # surfaced on next wait()
                self._error = e
            self.write_s += time.perf_counter() - t0

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
