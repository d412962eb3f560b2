"""Wrappers for the fused logpdf kernels and the ``site_block_sum`` entry.

Three layers:

* Row wrappers ``std_normal_sum_rows`` / ``bernoulli_logit_sum_rows`` /
  ``gamma_unnorm_sum_rows``: take ``(B, n)`` float32 rows and return
  ``(B,)`` sums; ``categorical_logits_sum_rows`` takes ``(B, n, C)``
  logits and ``(B, n)`` int32 labels. On a CUDA tensor they launch the
  hand-written kernel in ``csrc/fused_logpdf.cu`` (or raise); on a CPU
  tensor they run the plain version in ``ref.py``. Each counts its kernel
  launches in ``LAUNCHES``.
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
           "bernoulli_logit_sum_rows", "categorical_logits_sum_rows",
           "gamma_unnorm_sum_rows", "std_normal_logpdf_sum",
           "bernoulli_logits_logpmf_sum", "categorical_logits_logpmf_sum",
           "gamma_unnorm_logpdf_sum", "site_block_sum", "kernel_source"]

SITE_BLOCK_FAMILIES = ("std_normal", "normal", "bernoulli_logits",
                       "categorical_logits", "gamma", "beta", "student_t",
                       "mvnormal_prec")
_NOT_PORTED = {
    "normal": "ROADMAP.md Queue 2 item 9 (normal_sum_2d)",
    "beta": "ROADMAP.md Queue 2 item 7 (beta_sum_2d)",
    "student_t": "ROADMAP.md Queue 2 item 8 (student_t_sum_2d)",
    "mvnormal_prec": "ROADMAP.md Queue 2 item 10 (mvn_quad_sum_2d)",
}

# kernel name -> launches since the last reset (one per wrapper call that
# reached the card; the CPU path does not count)
LAUNCHES = {"std_normal_sum": 0, "bernoulli_logit_sum": 0,
            "categorical_logits_sum": 0, "gamma_unnorm_sum": 0}

_THREADS = 256
_ITEMS_PER_THREAD = 8
_WARPS = _THREADS // 32  # categorical: one warp per item
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
        lib.repro_gamma_unnorm_sum.argtypes = [p, i64, p, i64, p, i64, i32,
                                               i64, p, i32, p, p]
        lib.repro_gamma_unnorm_sum.restype = i32
        lib.repro_categorical_logits_sum.argtypes = [p, i64, p, i64, i32, i64,
                                                     i32, p, i32, p, p]
        lib.repro_categorical_logits_sum.restype = i32
        lib.repro_cuda_error_string.argtypes = [i32]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _num_parts(n: int, per_block: int = _THREADS * _ITEMS_PER_THREAD) -> int:
    """Stage-1 blocks per row: a function of n alone (determinism)."""
    return max(1, min(_MAX_PARTS, -(-n // per_block)))


def _check_rows(name: str, t: torch.Tensor, rows: int, n: int,
                dtype: torch.dtype = torch.float32) -> None:
    """A kernel input: ``(rows, n)`` of ``dtype``, unit inner stride, row
    stride n (dense) or 0 (one row shared by every b)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
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


def gamma_unnorm_sum_rows(x: torch.Tensor, am1: torch.Tensor,
                          rate: torch.Tensor) -> torch.Tensor:
    """``out[b] = sum_i(am1[b, i] log x[b, i] - rate[b, i] x[b, i])`` for
    three ``(B, n)`` inputs; each may have row stride 0."""
    rows, n = x.shape
    for name, t in (("x", x), ("am1", am1), ("rate", rate)):
        _check_rows(name, t, rows, n)
    if _device_kind(x, am1, rate) == "cpu":
        return ref.gamma_unnorm_logpdf_sum_ref(x, am1, rate)
    out = torch.empty(rows, dtype=torch.float32, device=x.device)
    if n == 0:
        return out.zero_()
    nparts = _num_parts(n)
    partials = torch.empty(rows * nparts, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().repro_gamma_unnorm_sum(
            x.data_ptr(), _row_stride(x), am1.data_ptr(), _row_stride(am1),
            rate.data_ptr(), _row_stride(rate), rows, n, partials.data_ptr(),
            nparts, out.data_ptr(), stream)
    _raise_on(err, "gamma_unnorm_sum")
    LAUNCHES["gamma_unnorm_sum"] += 1
    return out


def categorical_logits_sum_rows(logits: torch.Tensor,
                                labels: torch.Tensor) -> torch.Tensor:
    """``out[b] = sum_i(logits[b, i, y] - logsumexp(logits[b, i]))`` with
    ``y = labels[b, i]``, for float32 ``logits (B, n, C)`` (classes dense,
    items C apart, row stride n*C or 0) and int32 ``labels (B, n)`` (row
    stride n or 0). A label outside ``[0, C)`` gives NaN."""
    if logits.dim() != 3:
        raise ValueError(f"logits: expected (B, n, C), got "
                         f"{tuple(logits.shape)}")
    rows, n, c = logits.shape
    if logits.dtype != torch.float32:
        raise TypeError(f"logits: expected float32, got {logits.dtype}")
    if c < 1:
        raise ValueError("logits: need at least one class")
    if ((c > 1 and logits.stride(2) != 1)
            or (n > 1 and logits.stride(1) != c)
            or (rows > 1 and logits.stride(0) not in (0, n * c))):
        raise ValueError(f"logits: strides {logits.stride()} not (n*C or 0, "
                         "C, 1)")
    _check_rows("labels", labels, rows, n, dtype=torch.int32)
    if _device_kind(logits, labels) == "cpu":
        return ref.categorical_logits_logpmf_sum_ref(logits, labels)
    out = torch.empty(rows, dtype=torch.float32, device=logits.device)
    if n == 0:
        return out.zero_()
    nparts = _num_parts(n, _WARPS)
    partials = torch.empty(rows * nparts, dtype=torch.float32,
                           device=logits.device)
    l_stride = logits.stride(0) if rows > 1 else n * c
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = _lib().repro_categorical_logits_sum(
            logits.data_ptr(), l_stride, labels.data_ptr(),
            _row_stride(labels), rows, n, c, partials.data_ptr(), nparts,
            out.data_ptr(), stream)
    _raise_on(err, "categorical_logits_sum")
    LAUNCHES["categorical_logits_sum"] += 1
    return out


def _addressable(t: torch.Tensor) -> torch.Tensor:
    """``t (rows, ...)`` as the kernels address it: each row dense and the
    row stride dense or 0 (one row shared by every b); anything else is
    made contiguous."""
    row = t[0]
    if row.is_contiguous() and (t.shape[0] == 1
                                or t.stride(0) in (0, row.numel())):
        return t
    return t.contiguous()


def _as_rows(t: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    """View ``t`` broadcast to ``shape`` as ``(B, n)`` rows: leading
    broadcast dims keep stride 0 (no copy); anything else the kernel cannot
    address is made contiguous."""
    return _addressable(t.to(torch.float32).expand(shape)
                        .reshape(-1, shape[-1]))


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


class _GammaUnnormSum(torch.autograd.Function):
    """``sum(am1 log x - rate x)`` over the last axis; analytic backward
    ``dx = g (am1/x - rate)``, ``dam1 = g log x``, ``drate = -g x``
    (the JAX package's ``ops.py:327``)."""

    @staticmethod
    def forward(x, am1, rate):
        shape = torch.broadcast_shapes(x.shape, am1.shape, rate.shape)
        out = gamma_unnorm_sum_rows(_as_rows(x, shape), _as_rows(am1, shape),
                                    _as_rows(rate, shape))
        return out.reshape(shape[:-1])

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        x, am1, rate = ctx.saved_tensors
        g = g.unsqueeze(-1)
        dx = dam1 = drate = None
        if ctx.needs_input_grad[0]:
            dx = (g * (am1 / x - rate)).sum_to_size(x.shape)
        if ctx.needs_input_grad[1]:
            dam1 = (g * torch.log(x)).sum_to_size(am1.shape)
        if ctx.needs_input_grad[2]:
            drate = (-g * x).sum_to_size(rate.shape)
        return dx, dam1, drate

    @staticmethod
    def vmap(info, in_dims, x, am1, rate):
        args = [t if d is None else t.movedim(d, 0)
                for t, d in zip((x, am1, rate), in_dims)]
        return _GammaUnnormSum.apply(*args), 0


class _CategoricalLogitsSum(torch.autograd.Function):
    """``sum_n log_softmax(logits_n)[labels_n]`` over the item axis of
    ``logits (..., N, C)``; analytic backward ``dl = g (onehot(labels) -
    softmax(logits))`` and no gradient for the int labels (the JAX
    package's ``ops.py:282``)."""

    @staticmethod
    def forward(logits, labels):
        c = logits.shape[-1]
        lead = torch.broadcast_shapes(logits.shape[:-1], labels.shape)
        n = lead[-1]
        out = categorical_logits_sum_rows(
            _addressable(logits.expand(lead + (c,)).reshape(-1, n, c)),
            _addressable(labels.expand(lead).reshape(-1, n)))
        return out.reshape(lead[:-1])

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        logits, labels = ctx.saved_tensors
        dl = None
        if ctx.needs_input_grad[0]:
            # one_hot as jax.nn.one_hot: all zeros for a label outside [0, C)
            classes = torch.arange(logits.shape[-1], device=logits.device)
            onehot = (labels.unsqueeze(-1) == classes).to(logits.dtype)
            dl = g[..., None, None] * (onehot - torch.softmax(logits, dim=-1))
            dl = dl.sum_to_size(logits.shape)
        return dl, None

    @staticmethod
    def vmap(info, in_dims, logits, labels):
        # the forward broadcasts the leading axes, so an unbatched input is
        # read with row stride 0 and the batch axis comes out in front
        args = [t if d is None else t.movedim(d, 0)
                for t, d in zip((logits, labels), in_dims)]
        return _CategoricalLogitsSum.apply(*args), 0


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


def gamma_unnorm_logpdf_sum(x: torch.Tensor, am1: torch.Tensor,
                            rate: torch.Tensor) -> torch.Tensor:
    """``sum(am1 log x - rate x)`` over the last axis (the Gamma normaliser
    ``a log b - lgamma(a)`` stays with the caller), differentiable in all
    three."""
    return _GammaUnnormSum.apply(torch.as_tensor(x, dtype=torch.float32),
                                 torch.as_tensor(am1, dtype=torch.float32),
                                 torch.as_tensor(rate, dtype=torch.float32))


def categorical_logits_logpmf_sum(logits: torch.Tensor,
                                  labels: torch.Tensor) -> torch.Tensor:
    """``sum_n log softmax(logits_n)[labels_n]`` over the item axis of
    ``logits (..., N, C)`` with int32 ``labels (..., N)``, differentiable
    in ``logits``."""
    labels = torch.as_tensor(labels)
    if labels.dtype != torch.int32:
        labels = labels.to(torch.int32)
    return _CategoricalLogitsSum.apply(
        torch.as_tensor(logits, dtype=torch.float32), labels)


def site_block_sum(family: str, segments: Sequence[Tuple]) -> torch.Tensor:
    """Sum the log-densities of all same-family site segments in ONE launch.

    Parameters
    ----------
    family : str
        ``"std_normal"`` — segments ``(z,)``, 1-D standardised values (the
        ``-sum(log scale)`` term stays with the caller); or
        ``"bernoulli_logits"`` — segments ``(logits, y)``, each 1-D;
        ``"categorical_logits"`` — segments ``(logits (N_i, C), labels
        (N_i,))`` with int32 labels, all of one ``C``; or ``"gamma"`` —
        segments ``(x, a - 1, rate)``, each 1-D (``a log b - lgamma(a)``
        stays with the caller). The JAX package's other families raise
        ``NotImplementedError`` naming the ROADMAP item that ports them.
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
    if family == "gamma":
        return gamma_unnorm_logpdf_sum(*cols)
    if family == "categorical_logits":
        return categorical_logits_logpmf_sum(*cols)
    logits, y = cols
    return bernoulli_logits_logpmf_sum(logits, y)
