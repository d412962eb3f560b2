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
* :class:`CompiledProgram` — a function over the flat buffer with its
  compile step and call and signature accounting, the port's ``jax.jit``:
  on CUDA the body of each argument signature is recorded once as a
  ``torch.cuda.CUDAGraph`` (at its second call) and replayed after that;
  on the CPU it runs eagerly. ``retraces`` counts the signatures,
  ``captures`` and ``replays`` the graphs; :func:`disable_capture` is the
  port's ``jax.disable_jit``.
* :class:`ProgramCache` — keyed store with hit/miss/eviction counters
  and LRU eviction. Entries are ``CompiledProgram`` s, a sampler's set of
  them (``infer.chains.TransitionPrograms``), or plain build artefacts
  (``PotentialCompileResult``, ``ModelGraph``) that are expensive to
  rebuild: the potential compiler's probes are five density evaluations,
  the graph three replays of the model.

Which programs return the graph's own outputs (``donate_argnums``, as
``repro`` donates): the sampler and serving loops' own programs, whose
outputs and in-place buffers their loop consumes before the next call —
``TransitionPrograms``' warm and step (``run_chains``, ``make_chain_fn``),
NUTS's tree programs, MAP's step and the serving loop's decode step.
ADVI's and SGLD's steps and the density programs return fresh tensors.
The ``"package"`` program runs eagerly (``jit=False``): it runs once a
run and its output goes to the host.

The module-level default cache (``program_cache()``) is what
``run_chains``, the samplers and chain packaging share;
``cache_stats()``/``clear_cache()`` expose it for tests.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import inspect
import threading
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import SUPPORTED_NODES, tree_flatten, tree_unflatten

__all__ = ["CaptureError", "CompiledProgram", "GRAPH_COUNTS", "GraphPool",
           "ProgramCache", "ProgramKey",
           "cache_stats", "cached_potential", "clear_cache",
           "data_fingerprint", "density_program", "disable_capture",
           "kernel_fingerprint",
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


# ---------------------------------------------------------------------------
# The compile step: a program's body as a CUDA graph, one a signature
# ---------------------------------------------------------------------------
class CaptureError(RuntimeError):
    """A program's body could not be recorded as a CUDA graph."""


_NO_CAPTURE = [0]       # depth of disable_capture() blocks
# captures and replays of every program of the process, cached or not
GRAPH_COUNTS = {"captures": 0, "replays": 0}
_CAPTURING = []         # kinds of the programs being captured, innermost last
_CAPTURE_STREAMS = {}   # device index -> the stream every capture runs on
_NUMBERS = (bool, int, float, complex, np.number, np.bool_)


@contextlib.contextmanager
def disable_capture():
    """Run every program eagerly inside the block, as ``jax.disable_jit``
    runs every jitted function op by op. Signatures are still counted."""
    _NO_CAPTURE[0] += 1
    try:
        yield
    finally:
        _NO_CAPTURE[0] -= 1


_COUNTERS = []


def _launch_counters():
    """The ``LAUNCHES`` dicts of every kernel module."""
    if not _COUNTERS:
        from repro_torch.kernels.flash_attention import ops as flash
        from repro_torch.kernels.fused_leapfrog import ops as leapfrog
        from repro_torch.kernels.fused_logpdf import ops as logpdf
        from repro_torch.kernels.ssd_scan import ops as ssd
        _COUNTERS.extend((logpdf.LAUNCHES, leapfrog.LAUNCHES, flash.LAUNCHES,
                          ssd.LAUNCHES))
    return _COUNTERS


def _switch_state() -> bool:
    from repro_torch.kernels import fused_logpdf_enabled
    return fused_logpdf_enabled()


def _capture_stream(index: int) -> torch.cuda.Stream:
    stream = _CAPTURE_STREAMS.get(index)
    if stream is None:
        stream = _CAPTURE_STREAMS[index] = torch.cuda.Stream(index)
    return stream


_peek_transform = torch._C._functorch.peek_interpreter_stack


def _cuda_device(x):
    """The device a graph of the tensor or generator ``x`` would run on:
    CUDA's, else None."""
    return x.device if x.device.type == "cuda" else None


class GraphPool:
    """One CUDA graph memory pool that several programs capture into, in
    place of a private pool for each capture.

    For programs whose graphs replay one after another on one stream and
    whose outputs do not outlive the next replay: a sampler's
    transitions, which write their results into donated buffers and
    return nothing (``infer.chains.TransitionPrograms``), and a chain
    init, whose output is copied out at once. A later capture may then
    reuse the memory an earlier graph only needs while it replays, so the
    pool holds the largest graph's temporaries, not their sum. The handle
    is taken at the first capture, so building one needs no CUDA."""

    def __init__(self):
        self._handle = None

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle


@contextlib.contextmanager
def _recording(graph, dev: torch.device, pool: Optional[GraphPool] = None):
    """Record the block's CUDA work into ``graph``, on the capture stream
    of ``dev``, with that stream's kernel scratch sized first, into
    ``pool`` (a private pool when ``None``). The body's exception, if
    any, is the one raised."""
    from repro_torch.kernels import _scratch

    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    stream = _capture_stream(index)
    stream.wait_stream(torch.cuda.current_stream(index))
    _scratch.reserve(index, stream.cuda_stream)
    # no garbage collection inside the capture: a collected program would
    # destroy its graph there, which a capture does not permit
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.device(index), torch.cuda.stream(stream):
            graph.capture_begin(pool=None if pool is None
                                else pool.handle())
            try:
                yield
            except BaseException:
                try:
                    graph.capture_end()
                except Exception:  # noqa: BLE001 - the body's is the cause
                    pass
                raise
            graph.capture_end()
    finally:
        if collecting:
            gc.enable()
    torch.cuda.current_stream(index).wait_stream(stream)


# slot kinds of a captured graph's argument leaves
_PRIVATE, _PINNED, _DONATED, _GENERATOR, _VALUE = range(5)


class _Graph:
    """One capture: the graph, what each argument leaf became in it, its
    outputs and the kernel launches it replays."""

    __slots__ = ("graph", "slots", "out_leaves", "out_spec", "launches")


def _same(x, t) -> bool:
    return x is t or (x.data_ptr() == t.data_ptr() and x.shape == t.shape
                      and x.stride() == t.stride() and x.dtype == t.dtype)


class CompiledProgram:
    """One function over the flat buffer, with its compile step and call
    and signature accounting, as ``repro``'s ``jax.jit`` program.

    ``calls`` counts Python-level invocations and ``retraces`` the distinct
    argument signatures: the tree structure; each tensor leaf's shape,
    dtype and device; a static argument's value (``static_argnums``); and
    the per-array switch (``kernels.use_fused_logpdf``), whose route a
    graph records. ``retraces`` staying flat across repeated runs is what
    the "zero recompiles" tests assert.

    **Capture.** On CUDA the first call of a signature runs the body
    eagerly: it builds the kernels, their tables and scratch. The second
    records the body as a ``torch.cuda.CUDAGraph`` on a stream of its own
    and replays it; every later call replays it (``captures``,
    ``replays``). A one-shot program never pays for a capture. The CPU has
    no graph: there every call runs the body. A failed capture (a host
    sync, a pageable copy, an allocation that cannot be made) raises
    :class:`CaptureError` naming the program; nothing falls back.

    The graph reads a tensor argument from a buffer of its own, copied in
    at each replay, unless the same tensor was passed to the eager call
    before the capture (model weights, data): then it reads that tensor
    (pinned), and a later call with another one captures again. A
    ``torch.Generator`` argument is registered with the graph, so a replay
    draws from its state what the eager body would have drawn, and
    advances it; a later call with another generator lends that one's
    state to the registered one for the replay. A Python number that is
    not static is refused: a graph would bake its value (``jax.jit``
    traces it).

    ``donate_argnums`` name arguments (pytrees of tensors) that the body
    writes in place, as a sampler loop's state and draws: the graph reads
    and writes the caller's own tensors (a call with other tensors copies
    them in and back, and leaves the recorded ones as they were). A
    program with donated arguments returns the
    graph's own output tensors, which its caller (a loop) consumes
    before the next call; any other returns fresh copies, as ``repro``
    returns fresh arrays.

    Called on ``torch.func``-wrapped tensors, while a capture runs, or
    inside :func:`disable_capture`, the body runs inline, as a jitted
    function called inside another is inlined.

    Each capture takes a private memory pool unless ``pool`` (a
    :class:`GraphPool`) is given, which the programs of one sampler
    share. :meth:`forget` drops every signature and its graph.
    """

    def __init__(self, key: ProgramKey, raw: Callable, *, jit: bool = True,
                 static_argnums=(), donate_argnums=(),
                 pool: Optional[GraphPool] = None):
        self.key = key
        self.raw = raw
        self.jit = bool(jit)
        self.static_argnums = frozenset(_argnums(static_argnums))
        self.donate_argnums = frozenset(_argnums(donate_argnums))
        self.pool = pool
        self.calls = 0
        self.retraces = 0
        self.captures = 0
        self.replays = 0
        # signature -> weakrefs of the eager call's tensor leaves (before
        # the capture), or its _Graph
        self._seen = {}

    @property
    def kind(self) -> str:
        return self.key.kind

    def forget(self) -> None:
        """Drop every signature seen and its graph, with the tensors the
        graph holds (its buffers, donated arguments and outputs); the next
        call of a signature runs eagerly again and counts as a new one."""
        self._seen.clear()

    def _refuse(self, pos, what: str):
        name = pos if isinstance(pos, str) else _param_name(self.raw, pos)
        raise TypeError(
            f"program '{self.kind}': argument {name} is {what}; a graph "
            "would bake its value: pass a tensor, or name the argument in "
            "static_argnums")

    def _flatten(self, args, kwargs):
        """(leaves of the dynamic arguments, in ``torch.utils._pytree``'s
        order, and the signature)."""
        leaves, keys = [], []
        for pos, a in enumerate(args):
            if pos in self.static_argnums:
                try:
                    hash(a)
                except TypeError:
                    raise TypeError(
                        f"program '{self.kind}': static argument "
                        f"{_param_name(self.raw, pos)} is not hashable"
                    ) from None
                keys.append(("static", a))
            else:
                keys.append(self._walk(a, pos, leaves))
        if kwargs:
            keys.append(self._walk(kwargs, "keywords", leaves))
        return leaves, (_switch_state(), tuple(keys))

    def _walk(self, x, pos, leaves):
        """Append the leaves of ``x`` to ``leaves`` and return its part of
        the signature. Tuples, lists, dicts and named tuples are walked
        here (the hot path: a sampler's state); any other pytree container
        by ``torch.utils._pytree``, whose order this keeps."""
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            return (x.shape, x.dtype, x.device)
        t = type(x)
        if t is tuple or t is list or (isinstance(x, tuple)
                                       and hasattr(t, "_fields")):
            return (t, tuple([self._walk(v, pos, leaves) for v in x]))
        if t is dict:
            return (t, tuple(x), tuple([self._walk(v, pos, leaves)
                                        for v in x.values()]))
        if t in SUPPORTED_NODES:
            sub, spec = tree_flatten(x)
            return (spec, tuple([self._walk(v, pos, leaves) for v in sub]))
        leaves.append(x)
        if isinstance(x, torch.Generator):
            return ("generator", x.device)
        if x is None:
            return None
        if not self.jit:
            return (t.__name__,)
        if isinstance(x, _NUMBERS):
            self._refuse(pos, f"a Python {t.__name__}")
        try:
            hash(x)
        except TypeError:
            self._refuse(pos, f"a {t.__name__}, not a tensor")
        return ("value", x)

    def _rebuild(self, args, kwargs, leaves):
        """``args`` and ``kwargs`` with their dynamic leaves replaced."""
        it = iter(leaves)
        new_args = []
        for pos, a in enumerate(args):
            if pos in self.static_argnums:
                new_args.append(a)
            elif torch.is_tensor(a):
                new_args.append(next(it))
            else:
                sub, spec = tree_flatten(a)
                new_args.append(tree_unflatten([next(it) for _ in sub], spec))
        if kwargs:
            sub, spec = tree_flatten(kwargs)
            kwargs = tree_unflatten([next(it) for _ in sub], spec)
        return new_args, kwargs

    def _donated_mask(self, args, kwargs):
        mask = []
        for pos, a in enumerate(args):
            if pos in self.static_argnums:
                continue
            n = 1 if torch.is_tensor(a) else len(tree_flatten(a)[0])
            mask.extend([pos in self.donate_argnums] * n)
        if kwargs:
            mask.extend([False] * len(tree_flatten(kwargs)[0]))
        return mask

    def __call__(self, *args, **kwargs):
        self.calls += 1
        leaves, sig = self._flatten(args, kwargs)
        entry = self._seen.get(sig)
        if entry is None:
            self.retraces += 1
            self._seen[sig] = entry = ()
        dev = None
        # inline inside a torch.func transform (vmap, grad) and inside a
        # capture; eager with capture off
        if self.jit and not _NO_CAPTURE[0] and _peek_transform() is None:
            for x in leaves:  # the first CUDA tensor or generator
                if isinstance(x, (torch.Tensor, torch.Generator)):
                    dev = _cuda_device(x)
                    if dev is not None:
                        break
            if dev is not None and (
                    _CAPTURING or torch.cuda.is_current_stream_capturing()):
                dev = None
        if dev is None:  # the CPU, inline, or capture off
            return self.raw(*args, **kwargs)
        if isinstance(entry, _Graph):
            out = self._replay(entry, leaves)
            if out is not _MISMATCH:
                return out
            # a pinned argument changed: run eagerly, capture again next
            entry = ()
        if entry == ():  # the eager call before the capture
            self._seen[sig] = tuple(weakref.ref(x) if torch.is_tensor(x)
                                    else None for x in leaves)
            return self.raw(*args, **kwargs)
        graph = self._capture(args, kwargs, leaves, entry, dev)
        self._seen[sig] = graph
        self.captures += 1
        GRAPH_COUNTS["captures"] += 1
        return self._replay(graph, leaves)

    def _capture(self, args, kwargs, leaves, eager_refs, dev) -> _Graph:
        from repro_torch.kernels import _scratch

        g = _Graph()
        g.graph = torch.cuda.CUDAGraph()
        g.slots, registered = [], set()
        donated = self._donated_mask(args, kwargs)
        inner = []
        for i, x in enumerate(leaves):
            if isinstance(x, torch.Generator):
                if id(x) not in registered:
                    g.graph.register_generator_state(x)
                    registered.add(id(x))
                g.slots.append((_GENERATOR, x))
                inner.append(x)
            elif not torch.is_tensor(x):
                g.slots.append((_VALUE, None))
                inner.append(x)
            elif donated[i]:
                g.slots.append((_DONATED, x))
                inner.append(x)
            elif eager_refs[i] is not None and eager_refs[i]() is x:
                g.slots.append((_PINNED, x))
                inner.append(x)
            else:
                buf = x.clone()
                g.slots.append((_PRIVATE, buf))
                inner.append(buf)
        cargs, ckwargs = self._rebuild(args, kwargs, inner)
        counters = _launch_counters()
        before = [dict(c) for c in counters]
        _CAPTURING.append(self.kind)
        try:
            with _recording(g.graph, dev, self.pool):
                out = self.raw(*cargs, **ckwargs)
        except Exception as exc:
            raise CaptureError(
                f"program '{self.kind}' could not be captured as a CUDA "
                f"graph: {type(exc).__name__}: {exc}") from exc
        finally:
            _CAPTURING.pop()
            g.launches = tuple(
                tuple((k, c[k] - b[k]) for k in c if c[k] != b[k])
                for c, b in zip(counters, before))
            for c, b in zip(counters, before):
                c.update(b)
        g.out_leaves, g.out_spec = tree_flatten(out)
        return g

    def _replay(self, g: _Graph, leaves):
        copy_back, swaps = [], {}
        for (kind, t), x in zip(g.slots, leaves):
            if kind == _PINNED and not _same(x, t):
                return _MISMATCH
        for (kind, t), x in zip(g.slots, leaves):
            if kind == _PRIVATE:
                t.copy_(x)
            elif kind == _DONATED and not _same(x, t):
                # the recorded tensor is its first caller's: kept aside
                copy_back.append((x, t, t.clone()))
                t.copy_(x)
            elif kind == _GENERATOR and x is not t and id(t) not in swaps:
                # another generator: the registered one draws from its
                # state, then hands it back and takes its own again
                swaps[id(t)] = (x, t, t.get_state())
                t.set_state(x.get_state())
        g.graph.replay()
        for x, t, kept in swaps.values():
            x.set_state(t.get_state())
            t.set_state(kept)
        for x, t, kept in copy_back:
            x.copy_(t)
            t.copy_(kept)
        for counter, added in zip(_launch_counters(), g.launches):
            for k, n in added:
                counter[k] += n
        self.replays += 1
        GRAPH_COUNTS["replays"] += 1
        outs = g.out_leaves
        if not self.donate_argnums:
            outs = [o.clone() if torch.is_tensor(o) else o for o in outs]
        return tree_unflatten(outs, g.out_spec)

    def __repr__(self):
        return (f"CompiledProgram({self.kind}, calls={self.calls}, "
                f"retraces={self.retraces}, captures={self.captures}, "
                f"replays={self.replays})")


_MISMATCH = object()


def _argnums(nums) -> Tuple[int, ...]:
    return (int(nums),) if isinstance(nums, int) else tuple(int(n)
                                                            for n in nums)


def _param_name(fn: Callable, pos) -> str:
    if isinstance(pos, str):
        return pos
    try:
        names = list(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        names = []
    return (f"{pos} ('{names[pos]}')" if pos < len(names)
            and not names[pos].startswith("*") else str(pos))


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
        progs = []
        for v in self._entries.values():  # programs, and samplers' sets
            progs.extend([v] if isinstance(v, CompiledProgram)
                         else getattr(v, "programs", ()))
        return {
            "size": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "retraces": sum(p.retraces for p in progs),
            "calls": sum(p.calls for p in progs),
            "captures": sum(p.captures for p in progs),
            "replays": sum(p.replays for p in progs),
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

    The compile is graph-gated and runs several replay probes — caching
    it is what makes repeated ``run_chains`` calls and the
    analysis-after-sampling path free. ``allow_conditional`` is part of
    the key and reaches the compiler, as in ``repro``.
    """
    cache = cache if cache is not None else _DEFAULT_CACHE
    key = ProgramKey(model_fingerprint(model), "potential",
                     tvi_linked.layout, (), backend,
                     (ctx, bool(allow_conditional)))

    def build():
        from repro_torch.core.potential import compile_potential
        return compile_potential(model, tvi_linked, ctx=ctx, backend=backend,
                                 allow_conditional=allow_conditional)

    return cache.get_or_build(key, build)


def model_graph(model, tvi, ctx=None,
                cache: Optional[ProgramCache] = None):
    """Cached :func:`repro_torch.analysis.graph.build_model_graph`.

    ``build_model_graph`` invlinks linked traces itself and its output is
    structural (value-independent; dynamic structure is detected by its
    own multi-generator probe), so linked and unlinked callers — the
    potential compiler and ``Model.analyze`` — share one entry keyed on
    (model, layout, ctx).
    """
    cache = cache if cache is not None else _DEFAULT_CACHE
    layout = tvi.layout if tvi is not None else None
    key = ProgramKey(model_fingerprint(model), "graph", layout, (),
                     "fused", (ctx,))

    def build():
        from repro_torch.analysis.graph import build_model_graph
        return build_model_graph(model, tvi, ctx=ctx)

    return cache.get_or_build(key, build)
