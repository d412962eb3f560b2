"""Wrappers for the fused logpdf kernels and the ``site_block_sum`` entry.

Three layers:

* Row wrappers ``std_normal_sum_rows`` / ``bernoulli_logit_sum_rows``: take
  ``(B, n)`` float32 rows and return ``(B,)`` sums. On a CUDA tensor they
  launch the hand-written kernel in ``csrc/fused_logpdf.cu`` (or raise);
  on a CPU tensor they run the plain version in ``ref.py``. Each counts its
  kernel launches in ``LAUNCHES``.
* One ``torch.autograd.Function`` per family with the analytic backward of
  the JAX package's ``custom_vjp`` and a ``vmap`` rule: under
  ``torch.func.vmap`` over HMC chains the whole chain axis goes to ONE
  kernel launch as the row axis.
* ``site_block_sum(family, segments)``: the flat-buffer log-joint hot path.
  The fused evaluators gather all same-family tilde sites of one model run
  into segments; this concatenates them and sums the block in one launch.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Sequence, Tuple

import torch

from repro_torch.kernels._build import KernelError, load_library
from repro_torch.kernels.fused_logpdf import ref

__all__ = ["SITE_BLOCK_FAMILIES", "LAUNCHES",
           "reset_launch_counts", "std_normal_sum_rows",
           "bernoulli_logit_sum_rows", "std_normal_logpdf_sum",
           "bernoulli_logits_logpmf_sum", "site_block_sum", "kernel_source"]

SITE_BLOCK_FAMILIES = ("std_normal", "normal", "bernoulli_logits",
                       "categorical_logits", "gamma", "beta", "student_t",
                       "mvnormal_prec")
_NOT_PORTED = {
    "categorical_logits": "ROADMAP.md Queue 2 item 3 (categorical_sum_2d)",
    "normal": "ROADMAP.md Queue 2 item 9 (normal_sum_2d)",
    "gamma": "ROADMAP.md Queue 2 item 6 (gamma_sum_2d)",
    "beta": "ROADMAP.md Queue 2 item 7 (beta_sum_2d)",
    "student_t": "ROADMAP.md Queue 2 item 8 (student_t_sum_2d)",
    "mvnormal_prec": "ROADMAP.md Queue 2 item 10 (mvn_quad_sum_2d)",
}

# kernel name -> launches since the last reset (one per wrapper call that
# reached the card; the CPU path does not count)
LAUNCHES = {"std_normal_sum": 0, "bernoulli_logit_sum": 0}

_THREADS = 256
_ITEMS_PER_THREAD = 8
_MAX_PARTS = 1024


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_source() -> Path:
    return Path(__file__).resolve().parent / "csrc" / "fused_logpdf.cu"


_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = load_library(kernel_source())
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.repro_std_normal_sum.argtypes = [p, i64, i32, i64, p, i32, p, p]
        lib.repro_std_normal_sum.restype = i32
        lib.repro_bernoulli_logit_sum.argtypes = [p, i64, p, i64, i32, i64,
                                                  p, i32, p, p]
        lib.repro_bernoulli_logit_sum.restype = i32
        lib.repro_cuda_error_string.argtypes = [i32]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _num_parts(n: int) -> int:
    """Stage-1 blocks per row: a function of n alone (determinism)."""
    per_block = _THREADS * _ITEMS_PER_THREAD
    return max(1, min(_MAX_PARTS, -(-n // per_block)))


def _check_rows(name: str, t: torch.Tensor, rows: int, n: int) -> None:
    """A kernel input: float32 ``(rows, n)``, unit inner stride, row stride
    n (dense) or 0 (one row shared by every b)."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if t.dim() != 2 or tuple(t.shape) != (rows, n):
        raise ValueError(f"{name}: expected shape {(rows, n)}, got "
                         f"{tuple(t.shape)}")
    if n > 1 and t.stride(1) != 1:
        raise ValueError(f"{name}: inner stride must be 1, got {t.stride()}")
    if rows > 1 and t.stride(0) not in (0, n):
        raise ValueError(f"{name}: row stride must be {n} or 0, got "
                         f"{t.stride(0)}")


def _row_stride(t: torch.Tensor) -> int:
    return t.stride(0) if t.shape[0] > 1 else t.shape[1]


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        msg = _lib().repro_cuda_error_string(err).decode()
        raise KernelError(f"{kernel} launch failed: CUDA error {err} ({msg})")


def _device_kind(*ts: torch.Tensor) -> str:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {sorted(map(str, devs))}")
    kind = ts[0].device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no fused_logpdf kernel for device '{kind}'")
    return kind


def std_normal_sum_rows(z: torch.Tensor) -> torch.Tensor:
    """``out[b] = sum_i(-z[b, i]^2 / 2 - log(2 pi) / 2)`` for ``z (B, n)``."""
    rows, n = z.shape
    _check_rows("z", z, rows, n)
    if _device_kind(z) == "cpu":
        return ref.std_normal_logpdf_sum_ref(z)
    out = torch.empty(rows, dtype=torch.float32, device=z.device)
    if n == 0:
        return out.zero_()
    nparts = _num_parts(n)
    partials = torch.empty(rows * nparts, dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = _lib().repro_std_normal_sum(
            z.data_ptr(), _row_stride(z), rows, n, partials.data_ptr(),
            nparts, out.data_ptr(), stream)
    _raise_on(err, "std_normal_sum")
    LAUNCHES["std_normal_sum"] += 1
    return out


def bernoulli_logit_sum_rows(logits: torch.Tensor,
                             y: torch.Tensor) -> torch.Tensor:
    """``out[b] = sum_i(-softplus(-l[b, i]) - (1 - y[b, i]) l[b, i])`` for
    ``logits (B, n)`` and ``y (B, n)``; ``y`` may have row stride 0."""
    rows, n = logits.shape
    _check_rows("logits", logits, rows, n)
    _check_rows("y", y, rows, n)
    if _device_kind(logits, y) == "cpu":
        return ref.bernoulli_logits_logpmf_sum_ref(logits, y)
    out = torch.empty(rows, dtype=torch.float32, device=logits.device)
    if n == 0:
        return out.zero_()
    nparts = _num_parts(n)
    partials = torch.empty(rows * nparts, dtype=torch.float32,
                           device=logits.device)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = _lib().repro_bernoulli_logit_sum(
            logits.data_ptr(), _row_stride(logits), y.data_ptr(),
            _row_stride(y), rows, n, partials.data_ptr(), nparts,
            out.data_ptr(), stream)
    _raise_on(err, "bernoulli_logit_sum")
    LAUNCHES["bernoulli_logit_sum"] += 1
    return out


def _as_rows(t: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    """View ``t`` broadcast to ``shape`` as ``(B, n)`` rows: leading
    broadcast dims keep stride 0 (no copy); anything else the kernel cannot
    address is made contiguous."""
    rows = t.to(torch.float32).expand(shape).reshape(-1, shape[-1])
    if ((rows.shape[1] > 1 and rows.stride(1) != 1)
            or (rows.shape[0] > 1 and rows.stride(0) not in (0, rows.shape[1]))):
        rows = rows.contiguous()
    return rows


class _StdNormalSum(torch.autograd.Function):
    """``sum(-z^2/2 - log(2 pi)/2)`` over the last axis; analytic backward
    ``dz = -z * g`` (the JAX package's ``ops.py:109``)."""

    @staticmethod
    def forward(z):
        shape = z.shape
        return std_normal_sum_rows(_as_rows(z, shape)).reshape(shape[:-1])

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, g):
        (z,) = ctx.saved_tensors
        return -z * g.unsqueeze(-1)

    @staticmethod
    def vmap(info, in_dims, z):
        # the forward reduces the last axis for any leading shape, so the
        # batch axis moved to the front becomes the kernel's row axis
        return _StdNormalSum.apply(z.movedim(in_dims[0], 0)), 0


class _BernoulliLogitSum(torch.autograd.Function):
    """``sum(-softplus(-l) - (1-y) l)`` over the last axis; analytic
    backward ``dl = g (y - sigmoid(l))``, ``dy = g l`` (``ops.py:225``)."""

    @staticmethod
    def forward(logits, y):
        shape = torch.broadcast_shapes(logits.shape, y.shape)
        out = bernoulli_logit_sum_rows(_as_rows(logits, shape),
                                       _as_rows(y, shape))
        return out.reshape(shape[:-1])

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        logits, y = ctx.saved_tensors
        g = g.unsqueeze(-1)
        dl = dy = None
        if ctx.needs_input_grad[0]:
            dl = (g * (y - torch.sigmoid(logits))).sum_to_size(logits.shape)
        if ctx.needs_input_grad[1]:
            dy = (g * logits).sum_to_size(y.shape)
        return dl, dy

    @staticmethod
    def vmap(info, in_dims, logits, y):
        # an unbatched input keeps its logical shape and broadcasts over the
        # batch axis inside forward, which the kernel reads with row stride 0
        ld, yd = in_dims
        logits = logits if ld is None else logits.movedim(ld, 0)
        y = y if yd is None else y.movedim(yd, 0)
        return _BernoulliLogitSum.apply(logits, y), 0


def std_normal_logpdf_sum(z: torch.Tensor) -> torch.Tensor:
    """``sum(StdNormal.log_prob(z))`` over the last axis, differentiable."""
    return _StdNormalSum.apply(torch.as_tensor(z, dtype=torch.float32))


def bernoulli_logits_logpmf_sum(logits: torch.Tensor,
                                y: torch.Tensor) -> torch.Tensor:
    """``sum(y log sigmoid(l) + (1-y) log sigmoid(-l))`` over the last
    axis, differentiable in ``logits`` and ``y``."""
    return _BernoulliLogitSum.apply(
        torch.as_tensor(logits, dtype=torch.float32),
        torch.as_tensor(y, dtype=torch.float32))


def site_block_sum(family: str, segments: Sequence[Tuple]) -> torch.Tensor:
    """Sum the log-densities of all same-family site segments in ONE launch.

    Parameters
    ----------
    family : str
        ``"std_normal"`` — segments ``(z,)``, 1-D standardised values (the
        ``-sum(log scale)`` term stays with the caller); or
        ``"bernoulli_logits"`` — segments ``(logits, y)``, each 1-D. The
        JAX package's other families raise ``NotImplementedError`` naming
        the ROADMAP item that ports them.
    segments : sequence of tuples of tensors
        Per-site flattened blocks as above.

    Returns
    -------
    torch.Tensor, scalar float32
        ``sum_i sum(logpdf(segment_i))``, differentiable in the segments
        (analytic backward) and batched over chains under ``vmap``.
    """
    if family not in SITE_BLOCK_FAMILIES:
        raise ValueError(f"unknown site-block family '{family}'; "
                         f"expected one of {SITE_BLOCK_FAMILIES}")
    if family in _NOT_PORTED:
        raise NotImplementedError(
            f"site-block family '{family}' has no CUDA kernel in the port "
            f"yet: {_NOT_PORTED[family]}")
    if not segments:
        return torch.zeros((), dtype=torch.float32)
    if len(segments) == 1:
        cols = segments[0]
    else:
        cols = tuple(torch.cat(parts, dim=0) for parts in zip(*segments))
    if family == "std_normal":
        (z,) = cols
        return std_normal_logpdf_sum(z)
    logits, y = cols
    return bernoulli_logits_logpmf_sum(logits, y)
