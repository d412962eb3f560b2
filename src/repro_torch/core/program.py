"""Program ABI + cache — ONE program per (model, query), as ``repro``'s.

Every consumer of the flat-buffer representation (the samplers in
``repro_torch.infer``, chain packaging, the ADVI and SGLD steps) used to
build its own closure, and ``run_chains`` its own density and separable
spec, on every call. This module gives all of them one shared ABI:

* :class:`ProgramKey` — the explicit cache key: ``(model fingerprint,
  kind, FlatLayout, batch shape, backend, extra)``. Everything in it is
  hashable and value-complete: model identity is the ``ModelGen`` uid
  plus a content hash of the bound data (tensors and arrays by shape,
  dtype, device and sha1 of their bytes), so rebinding data to new values
  never reuses a stale program.
* :class:`CompiledProgram` — a function over the flat buffer with call
  and signature accounting. PyTorch runs it eagerly: there is no compile
  step yet, and ``retraces`` counts the distinct argument signatures
  (shape, dtype and device of each tensor leaf) it has been called with.
  Each of those signatures is one capture that a CUDA-graph replay of the
  program will need (ROADMAP.md Queue 1 item 11b).
* :class:`ProgramCache` — keyed store with hit/miss/eviction counters
  and LRU eviction. Entries are ``CompiledProgram`` s or plain build
  artefacts (``PotentialCompileResult``) that are expensive to rebuild:
  the separable-spec compiler's probes are five density evaluations.

The module-level default cache (``program_cache()``) is what
``run_chains``, the samplers and chain packaging share;
``cache_stats()``/``clear_cache()`` expose it for tests.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = ["CompiledProgram", "ProgramCache", "ProgramKey",
           "cache_stats", "cached_potential", "clear_cache",
           "data_fingerprint", "density_program", "kernel_fingerprint",
           "model_fingerprint", "model_graph", "program_cache",
           "trace_fingerprint"]


# ---------------------------------------------------------------------------
# Fingerprints: hashable, value-complete identities for key components
# ---------------------------------------------------------------------------
def _transformed(t: torch.Tensor) -> bool:
    """Whether ``t`` is wrapped by a ``torch.func`` transform (vmap, grad)."""
    return torch._C._functorch.is_functorch_wrapped_tensor(t)


def data_fingerprint(v) -> Tuple:
    """Hashable content fingerprint of one bound-data value.

    Tensors and arrays hash by (shape, dtype, device, sha1 of bytes): a
    program built against one dataset is never served for another. A
    tensor wrapped by a ``torch.func`` transform is refused loudly: it has
    no content of its own, and keying on it would alias every value the
    transform passes through to one program.
    """
    from repro_torch.core.primitives import missing

    if v is missing:
        return ("missing",)
    if v is None:
        return ("none",)
    if isinstance(v, (bool, int, float, complex, str, bytes)):
        return ("lit", type(v).__name__, v)
    if isinstance(v, dict):
        return ("dict", tuple(sorted((str(k), data_fingerprint(x))
                                     for k, x in v.items())))
    if isinstance(v, (tuple, list)):
        return ("seq", type(v).__name__,
                tuple(data_fingerprint(x) for x in v))
    if torch.is_tensor(v):
        if _transformed(v):
            raise ValueError(
                "cannot fingerprint a tensor inside a torch.func transform "
                "for a ProgramKey; traced data must be an INPUT of the "
                "program, not part of its cache key")
        # the bytes as uint8, so that types numpy lacks (bfloat16) hash too
        raw = v.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
        digest = hashlib.sha1(raw.numpy().tobytes()).hexdigest()[:16]
        return ("tensor", tuple(v.shape), str(v.dtype), str(v.device),
                digest)
    if isinstance(v, (np.ndarray, np.generic)):
        arr = np.ascontiguousarray(v)
        digest = hashlib.sha1(arr.tobytes()).hexdigest()[:16]
        return ("arr", tuple(arr.shape), str(arr.dtype), digest)
    # Model/ModelGen values (submodel-style bindings) get structural ids
    fp = _maybe_model_fingerprint(v)
    if fp is not None:
        return fp
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return ("dataclass", type(v).__name__,
                tuple((f.name, data_fingerprint(getattr(v, f.name)))
                      for f in dataclasses.fields(v)))
    return ("id", type(v).__name__, id(v))


def _maybe_model_fingerprint(v) -> Optional[Tuple]:
    from repro_torch.core.model import Model, ModelGen
    if isinstance(v, (Model, ModelGen)):
        return model_fingerprint(v)
    return None


def model_fingerprint(m) -> Tuple:
    """Identity of a Model/ModelGen: generator uid + bound-data content.

    The uid is a process-monotonic counter stamped in
    ``ModelGen.__init__``: unlike ``id()`` it is never reused after
    garbage collection, so two distinct generators never collide on one
    cached program.
    """
    from repro_torch.core.model import Model, ModelGen
    if isinstance(m, ModelGen):
        return ("modelgen", m.name, m._uid)
    if isinstance(m, Model):
        data = tuple(sorted((k, data_fingerprint(v))
                            for k, v in m.data.items()))
        return ("model", m.gen.name, m.gen._uid, data)
    raise TypeError(f"expected Model or ModelGen, got {type(m).__name__}")


def trace_fingerprint(tvi) -> Tuple:
    """Identity of a typed trace for programs that BAKE its dist params.

    ``package_draws``-style programs invlink through the trace's stored
    distributions, whose parameters may depend on the discovery draw
    (e.g. ``Uniform(lo, hi)`` bounds computed from another site), so the
    layout alone is not enough and the distributions' parameters are
    content-hashed in. Density programs re-execute the model and do NOT
    need this (they key on layout only).
    """
    return ("tvi", tvi.layout, bool(tvi.linked),
            tuple(data_fingerprint(d) for d in tvi.dists))


def kernel_fingerprint(kernel) -> Optional[Tuple]:
    """Configuration fingerprint of a sampler (HMC/NUTS/RWMH dataclass).

    Returns ``None`` for non-dataclass kernels: callers must then bypass
    the cache rather than risk aliasing two behaviours.
    """
    if not dataclasses.is_dataclass(kernel):
        return None
    try:
        fields = tuple((f.name, data_fingerprint(getattr(kernel, f.name)))
                       for f in dataclasses.fields(kernel))
    except ValueError:
        return None
    return ("kernel", type(kernel).__name__, fields)


# ---------------------------------------------------------------------------
# The program ABI
# ---------------------------------------------------------------------------
class ProgramKey(NamedTuple):
    """Explicit cache key: every axis a program specialises on.

    Attributes
    ----------
    model : tuple
        :func:`model_fingerprint` of the bound model (or a bare
        ``("modelgen", ...)`` fingerprint for data-as-input programs).
    kind : str
        Program family: ``"density"``, ``"potential"``, ``"package"``,
        ``"advi_step"``, ``"sgld_step"``, ...
    layout : FlatLayout or None
        The flat-buffer layout the program addresses (None for programs
        that take their data as inputs, e.g. the SGLD steps).
    batch : tuple
        Batch shape; ``()`` for scalar programs.
    backend : str
        Density backend (``"fused"``/``"reference"``).
    extra : tuple
        Kind-specific hashable tail (context, kernel fingerprint, data
        shape signature, ...).
    sharding : tuple
        Device-placement fingerprint; ``()`` for the single-device path,
        the only one the port has (ROADMAP.md Queue 1 item 8).
    """

    model: Tuple
    kind: str
    layout: Any
    batch: Tuple
    backend: str
    extra: Tuple = ()
    sharding: Tuple = ()


def _leaf_signature(x) -> Tuple:
    if torch.is_tensor(x):
        return (tuple(x.shape), x.dtype, x.device)
    return (type(x).__name__,)


def _signature(args, kwargs) -> Tuple:
    """The argument signature a capture would specialise on: the tree
    structure, and the shape, dtype and device of each tensor leaf (a
    non-tensor leaf by its type alone)."""
    if not kwargs and all(torch.is_tensor(a) for a in args):
        return tuple(_leaf_signature(a) for a in args)  # the hot path
    from torch.utils._pytree import tree_flatten
    leaves, spec = tree_flatten((args, kwargs))
    return (str(spec), tuple(_leaf_signature(x) for x in leaves))


class CompiledProgram:
    """One function over the flat buffer, with call and signature accounting.

    ``calls`` counts Python-level invocations. The port runs the body
    eagerly (there is no compile step), and ``retraces`` counts the
    distinct argument signatures seen: one for repeated calls at one
    shape, one more for each new shape, as a jitted program's trace count
    does. Each signature is one capture that replaying the program as a
    CUDA graph will need (ROADMAP.md Queue 1 item 11b); ``retraces``
    staying flat across repeated runs is what the "zero recompiles" tests
    assert.
    """

    def __init__(self, key: ProgramKey, raw: Callable):
        self.key = key
        self.raw = raw
        self.calls = 0
        self.retraces = 0
        self._seen = set()

    def __call__(self, *args, **kwargs):
        self.calls += 1
        sig = _signature(args, kwargs)
        if sig not in self._seen:
            self._seen.add(sig)
            self.retraces += 1
        return self.raw(*args, **kwargs)

    def __repr__(self):
        return (f"CompiledProgram({self.key.kind}, calls={self.calls}, "
                f"retraces={self.retraces})")


class ProgramCache:
    """Keyed LRU store of programs and build artefacts.

    ``get_or_build(key, builder)`` is the only write path: a hit moves
    the entry to the MRU end; a miss invokes ``builder()`` and may evict
    the LRU entry. All counters are plain ints.
    """

    def __init__(self, maxsize: int = 128):
        self.maxsize = int(maxsize)
        self._entries: "OrderedDict[ProgramKey, Any]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get_or_build(self, key: ProgramKey, builder: Callable[[], Any]):
        with self._lock:
            if key in self._entries:
                self.hits += 1
                self._entries.move_to_end(key)
                return self._entries[key]
            self.misses += 1
        # build OUTSIDE the lock: builders replay models and may reenter
        # the cache
        value = builder()
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
                self.evictions += 1
        return value

    def get(self, key: ProgramKey):
        """Peek without building (no hit/miss accounting)."""
        return self._entries.get(key)

    def __contains__(self, key: ProgramKey) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self):
        return list(self._entries.keys())

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.hits = self.misses = self.evictions = 0

    def stats(self) -> Dict[str, int]:
        """Aggregate counters, including per-program signature accounting."""
        progs = [v for v in self._entries.values()
                 if isinstance(v, CompiledProgram)]
        return {
            "size": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "retraces": sum(p.retraces for p in progs),
            "calls": sum(p.calls for p in progs),
        }


_DEFAULT_CACHE = ProgramCache()


def program_cache() -> ProgramCache:
    """The process-wide default cache shared by the samplers."""
    return _DEFAULT_CACHE


def cache_stats() -> Dict[str, int]:
    return _DEFAULT_CACHE.stats()


def clear_cache() -> None:
    _DEFAULT_CACHE.clear()


# ---------------------------------------------------------------------------
# Shared builders (lazy imports: program.py sits below model/potential)
# ---------------------------------------------------------------------------
def density_program(model, tvi_linked, ctx=None, backend: str = "fused",
                    cache: Optional[ProgramCache] = None) -> CompiledProgram:
    """Cached flat unconstrained log-density ``R^num_flat -> R``.

    The program re-executes the model under the fused evaluator, so it
    is a pure function of (model incl. data, layout, ctx, backend): the
    trace's VALUES are inputs, not constants, which is why two
    ``run_chains`` calls with different discovery draws share one
    program.
    """
    from repro_torch.core.contexts import DefaultContext
    cache = cache if cache is not None else _DEFAULT_CACHE
    ctx_key = ctx if ctx is not None else DefaultContext()
    key = ProgramKey(model_fingerprint(model), "density", tvi_linked.layout,
                     (), backend, (ctx_key,))

    def build():
        raw = model.make_logdensity_fn(tvi_linked, ctx=ctx, backend=backend)
        return CompiledProgram(key, raw)

    return cache.get_or_build(key, build)


def cached_potential(model, tvi_linked, ctx=None, backend: str = "fused",
                     allow_conditional: bool = True,
                     cache: Optional[ProgramCache] = None):
    """Cached :func:`repro_torch.core.potential.compile_potential` result.

    The compile replays the model and runs five probe evaluations of the
    density; caching it is what makes repeated ``run_chains`` calls free
    of them. ``allow_conditional`` is part of the key, as in ``repro``;
    the port compiles only the separable spec until the conditional one
    lands (ROADMAP.md Queue 1 item 5).
    """
    cache = cache if cache is not None else _DEFAULT_CACHE
    key = ProgramKey(model_fingerprint(model), "potential",
                     tvi_linked.layout, (), backend,
                     (ctx, bool(allow_conditional)))

    def build():
        from repro_torch.core.potential import compile_potential
        return compile_potential(model, tvi_linked, ctx=ctx, backend=backend)

    return cache.get_or_build(key, build)


def model_graph(model, tvi, ctx=None,
                cache: Optional[ProgramCache] = None):
    """``repro``'s cached dependency graph of a model. The port has no
    graph builder yet: it needs a tracer of its own (ROADMAP.md Queue 1
    item 5)."""
    raise NotImplementedError(
        "model_graph is not ported yet: the dependency graph needs a "
        "tracer of the port's own (ROADMAP.md Queue 1 item 5)")
