"""A CPU stand-in for CUDA-graph capture, for the port's program tests.

``emulate_capture(monkeypatch)`` makes ``core/program.py`` capture CPU
tensors: ``_recording`` records every aten op the body dispatches (under a
``TorchDispatchMode``) with the tensors it read and wrote, and the stand-in
graph's ``replay`` runs the recorded ops again on those same tensors,
writing each result into the tensor the capture produced. That is what a
CUDA graph does: fixed addresses, the ops and nothing of the Python around
them (counters, branches), draws from the generators the graph was given
(their states put back after the recording, as a capture draws nothing).
A host read of a tensor (``.item()``, ``bool()``) inside the body raises,
as it does inside a real capture.
"""
import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core import program

_HOST_READS = {torch.ops.aten._local_scalar_dense.default,
               torch.ops.aten.is_nonzero.default}


class _Recorder(TorchDispatchMode):
    """Records the ops, and what each in-place op overwrote first, so that
    the capture can be undone: a real capture runs nothing."""

    def __init__(self):
        super().__init__()
        self.ops = []
        self.saved = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _HOST_READS:
            raise RuntimeError("operation not permitted when stream is "
                               f"capturing ({func})")
        for arg, val in zip(func._schema.arguments, args):
            if (arg.alias_info is not None and arg.alias_info.is_write
                    and torch.is_tensor(val) and id(val) not in self.saved):
                self.saved[id(val)] = (val, val.clone())
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, out))
        return out


def _storage(t):
    return t.untyped_storage().data_ptr()


class FakeGraph:
    """Records at capture, replays the recorded ops (see module doc)."""

    def __init__(self):
        self.ops = None
        self.generators = []
        self.replays = 0

    def register_generator_state(self, gen):
        # a capture draws nothing: its generators' states are put back
        self.generators.append((gen, gen.get_state()))

    def replay(self):
        self.replays += 1
        for func, args, kwargs, out in self.ops:
            res = func(*args, **kwargs)
            outs, _ = tree_flatten(out)
            ress, _ = tree_flatten(res)
            for o, r in zip(outs, ress):
                if torch.is_tensor(o) and torch.is_tensor(r) \
                        and _storage(o) != _storage(r):
                    o.copy_(r)


@contextlib.contextmanager
def _recording(graph, dev, pool=None):
    graph.pool = pool  # the pool the capture was given, for the tests
    rec = _Recorder()
    try:
        with rec:
            yield
    finally:
        for t, old in reversed(list(rec.saved.values())):
            t.copy_(old)
        for gen, state in graph.generators:
            gen.set_state(state)
    graph.ops = rec.ops


def emulate_capture(monkeypatch):
    """Route CPU tensors through the capture path with the stand-in."""
    monkeypatch.setattr(program, "_cuda_device", lambda x: x.device)
    monkeypatch.setattr(program, "_recording", _recording)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
