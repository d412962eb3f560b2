"""Wrappers for the fused logpdf kernels and the ``site_block_sum`` entry.

Three layers:

* Row wrappers ``std_normal_sum_rows`` / ``bernoulli_logit_sum_rows`` /
  ``gamma_unnorm_sum_rows`` / ``normal_sum_rows`` / ``beta_unnorm_sum_rows``
  / ``student_t_unnorm_sum_rows``: take ``(B, n)`` float32 rows and return
  ``(B,)`` sums; ``categorical_logits_sum_rows`` takes ``(B, n, C)``
  logits and ``(B, n)`` int32 labels, ``mvn_quadform_sum_rows`` centred
  rows ``(B, N, D)`` and a precision ``(B, D, D)``. On a CUDA tensor they
  launch the hand-written kernel in ``csrc/fused_logpdf.cu`` or
  ``csrc/mvn_quad.cu`` (or raise); on a CPU tensor they run the plain
  version in ``ref.py``. Each counts its kernel launches in ``LAUNCHES``.
* One ``torch.autograd.Function`` per family with the analytic backward of
  the JAX package's ``custom_vjp`` and a ``vmap`` rule: under
  ``torch.func.vmap`` over HMC chains the whole chain axis goes to ONE
  kernel launch as the row axis.
* ``site_block_sum(family, segments)``: the flat-buffer log-joint hot path.
  The fused evaluators gather all same-family tilde sites of one model run
  into segments; this concatenates them and sums the block in one launch.
"""
from __future__ import annotations

import contextlib
import ctypes
from pathlib import Path
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels._build import KernelError, load_library
from repro_torch.kernels._dispatch import plain_requested
from repro_torch.kernels._scratch import last_block_scratch
from repro_torch.kernels.fused_logpdf import ref

__all__ = ["SITE_BLOCK_FAMILIES", "LAUNCHES",
           "reset_launch_counts", "std_normal_sum_rows",
           "bernoulli_logit_sum_rows", "categorical_logits_sum_rows",
           "gamma_unnorm_sum_rows", "normal_sum_rows", "beta_unnorm_sum_rows",
           "student_t_unnorm_sum_rows", "mvn_quadform_sum_rows",
           "std_normal_logpdf_sum", "normal_logpdf_sum",
           "bernoulli_logits_logpmf_sum", "categorical_logits_logpmf_sum",
           "gamma_unnorm_logpdf_sum", "beta_unnorm_logpdf_sum",
           "student_t_unnorm_logpdf_sum", "mvnormal_prec_quadform_sum",
           "site_block_sum", "kernel_source", "mvn_kernel_source",
           "categorical_group", "SMALL_C", "mvn_tiles", "mvn_smem_bytes",
           "MAX_SMEM_BYTES", "REDUCE_SHARE", "ReducePlan", "reduce_plan",
           "partials_needed", "CAT_ITEMS", "categorical_plan"]

SITE_BLOCK_FAMILIES = ("std_normal", "normal", "bernoulli_logits",
                       "categorical_logits", "gamma", "beta", "student_t",
                       "mvnormal_prec")

# kernel name -> launches since the last reset (one per wrapper call that
# reached the card; the CPU path does not count)
LAUNCHES = {"std_normal_sum": 0, "bernoulli_logit_sum": 0,
            "categorical_logits_sum": 0, "categorical_logits_sum_small": 0,
            "gamma_unnorm_sum": 0,
            "normal_sum": 0, "beta_unnorm_sum": 0, "student_t_unnorm_sum": 0,
            "mvn_quadform_sum": 0}

_THREADS = 256
SMALL_C = 256  # categorical: at most this many classes take the group path
# categorical above SMALL_C: one warp an item, so the items a block has in
# flight (fused_logpdf.cu kCatItems)
CAT_ITEMS = _THREADS // 32
MAX_SMEM_BYTES = 232_448  # shared memory one block may use on Hopper
_MAX_PARTS = 1024
_MVN_ROWS = 128  # rows of xc per block (mvn_quad.cu kRows)
# mvn_quadform_sum's last-block counts, by (device, stream): zero between
# calls (the kernel sets each back to zero), so they are allocated once
_MVN_COUNTS = {}
# the kernels of one launch a call (fused_logpdf.cu row_sum) and the floats
# of a row one block sums in a round (kShare); their scratch, and the large-C
# categorical_logits_sum's, is kernels._scratch's
_ONE_LAUNCH = ("std_normal_sum", "gamma_unnorm_sum", "beta_unnorm_sum",
               "student_t_unnorm_sum", "normal_sum", "bernoulli_logit_sum")
REDUCE_SHARE = 2048
_SAME_DEVICE = contextlib.nullcontext()  # the input is on the current device


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_source() -> Path:
    return Path(__file__).resolve().parent / "csrc" / "fused_logpdf.cu"


def mvn_kernel_source() -> Path:
    return Path(__file__).resolve().parent / "csrc" / "mvn_quad.cu"


_LIB = None
_MVN_LIB = None
_REDUCE_FNS = {}  # kernel name -> its bound ctypes function, set by _lib()


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = load_library(kernel_source())
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        # one launch: ..., rows, n, nparts, vec, partials, counts, out, stream
        tail = [i32, i64, i32, i32, p, p, p, p]
        strided = [p, i64, i64]  # pointer, row stride, element stride
        lib.repro_std_normal_sum.argtypes = [p, i64] + tail
        lib.repro_gamma_unnorm_sum.argtypes = [p, i64, p, i64, p, i64] + tail
        lib.repro_beta_unnorm_sum.argtypes = 3 * strided + tail
        lib.repro_student_t_unnorm_sum.argtypes = 2 * strided + tail
        lib.repro_normal_sum.argtypes = 3 * strided + tail
        lib.repro_bernoulli_logit_sum.argtypes = 2 * strided + tail
        # logits, row stride, labels, row stride, rows, n, c, then the tail
        lib.repro_categorical_logits_sum.argtypes = [p, i64, p, i64, i32, i64,
                                                     i32] + tail[2:]
        for name in _ONE_LAUNCH + ("categorical_logits_sum",):
            fn = getattr(lib, f"repro_{name}")
            fn.restype = i32
            _REDUCE_FNS[name] = fn
        lib.repro_categorical_logits_sum_small.argtypes = [
            p, i64, p, i64, i32, i64, i32, i32, p, i32, p, p]
        lib.repro_categorical_logits_sum_small.restype = i32
        lib.repro_cuda_error_string.argtypes = [i32]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _mvn_lib() -> ctypes.CDLL:
    global _MVN_LIB
    if _MVN_LIB is None:
        lib = load_library(mvn_kernel_source())
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.repro_mvn_quadform_sum.argtypes = [p, i64, p, i64, i32, i32, i32,
                                               p, i32, p, p, p]
        lib.repro_mvn_quadform_sum.restype = i32
        lib.repro_mvn_cuda_error_string.argtypes = [i32]
        lib.repro_mvn_cuda_error_string.restype = ctypes.c_char_p
        _MVN_LIB = lib
    return _MVN_LIB


def _num_parts(n: int, per_block: int) -> int:
    """Blocks a row of ``n`` items, ``per_block`` a block: a function of n
    alone (determinism)."""
    return max(1, min(_MAX_PARTS, -(-n // per_block)))


def _check_rows(name: str, t: torch.Tensor, rows: int, n: int,
                dtype: torch.dtype = torch.float32) -> None:
    """A kernel input: ``(rows, n)`` of ``dtype``, unit inner stride, row
    stride n (dense) or 0 (one row shared by every b)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.shape != (rows, n):
        raise ValueError(f"{name}: expected shape {(rows, n)}, got "
                         f"{tuple(t.shape)}")
    row_stride, inner = t.stride()
    if n > 1 and inner != 1:
        raise ValueError(f"{name}: inner stride must be 1, got {t.stride()}")
    if rows > 1 and row_stride != n and row_stride != 0:
        raise ValueError(f"{name}: row stride must be {n} or 0, got "
                         f"{row_stride}")


def _row_stride(t: torch.Tensor) -> int:
    return t.stride(0) if t.shape[0] > 1 else t.shape[1]


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        msg = (_mvn_lib().repro_mvn_cuda_error_string(err)
               if kernel == "mvn_quadform_sum"
               else _lib().repro_cuda_error_string(err)).decode()
        raise KernelError(f"{kernel} launch failed: CUDA error {err} ({msg})")


def _device_kind(*ts: torch.Tensor) -> str:
    dev = ts[0].device
    if any(t.device != dev for t in ts[1:]):
        devs = {str(t.device) for t in ts}
        raise ValueError(f"inputs on different devices: {sorted(devs)}")
    kind = dev.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no fused_logpdf kernel for device '{kind}'")
    return kind


class ReducePlan(NamedTuple):
    """How the one-launch kernels (``std_normal_sum``, ``gamma_unnorm_sum``,
    ``beta_unnorm_sum``, ``student_t_unnorm_sum``, ``normal_sum``,
    ``bernoulli_logit_sum``, and ``categorical_logits_sum`` above
    ``SMALL_C`` classes) launch: ``nparts`` blocks a row (1: the block
    writes the row's sum itself; more: the last block of a row to finish
    sums the row's partials) and ``vec``, 16-byte loads."""
    nparts: int
    vec: bool


def _vector_ready(addr: int, row_stride: int, elem_stride: int = 1) -> bool:
    """An input that 16-byte loads can read: one value a row (element
    stride 0, read once and never as a vector), or rows that all start
    16-byte aligned (row stride 0 included)."""
    return elem_stride == 0 or (addr % 16 == 0 and row_stride % 4 == 0)


def reduce_plan(n: int, inputs=()) -> ReducePlan:
    """The one-launch reduction of rows of ``n`` floats: ``nparts`` is
    ``ceil(n / REDUCE_SHARE)``, at most 1,024, from ``n`` alone (so reruns
    are bit-identical); 16-byte loads when every input, given as ``(address
    in bytes, row stride in floats)`` or ``(address, row stride, element
    stride)``, can take them: each row start 16-byte aligned, or an element
    stride of 0. Pure Python, as ``fused_logpdf.cu`` checks it."""
    nparts = max(1, min(_MAX_PARTS, -(-n // REDUCE_SHARE)))
    return ReducePlan(nparts, all(_vector_ready(*t) for t in inputs))


def categorical_plan(n: int, c: int, addr: int, row_stride: int) -> ReducePlan:
    """``categorical_logits_sum`` above ``SMALL_C`` classes on rows of
    ``n`` items: ``nparts`` is ``ceil(n / CAT_ITEMS)``, at most 1,024, from
    ``n`` alone; 16-byte loads when every item starts 16-byte aligned:
    ``c`` a multiple of 4 and the logits at ``addr`` (bytes) with rows
    ``row_stride`` floats apart (0 included) 16-byte aligned. Its scratch
    is ``partials_needed``'s, as the reductions'. Pure Python, as
    ``fused_logpdf.cu`` checks it."""
    nparts = max(1, min(_MAX_PARTS, -(-n // CAT_ITEMS)))
    return ReducePlan(nparts, c % 4 == 0 and _vector_ready(addr, row_stride))


def partials_needed(rows: int, plan: ReducePlan) -> int:
    """Floats of partials one call writes: one per (row, part), none when
    a row is one block."""
    return rows * plan.nparts if plan.nparts > 1 else 0


def _reduce_inputs(ins: Sequence[torch.Tensor], rows: int, n: int,
                   elem_strides: bool = False):
    """Each input of a one-launch reduction as the C side takes it:
    ``(address, row stride)``, or with ``elem_strides`` ``(address, row
    stride, element stride)``, where a row of one element counts as one
    value a row (element stride 0)."""
    if elem_strides:
        return [(t.data_ptr(), t.stride(0) if rows > 1 else 0,
                 t.stride(1) if n > 1 else 0) for t in ins]
    return [(t.data_ptr(), t.stride(0) if rows > 1 else 0) for t in ins]


def _reduce_rows(kernel: str, ins: Sequence[torch.Tensor], rows: int,
                 n: int, elem_strides: bool = False) -> torch.Tensor:
    """Launch one of the one-launch reductions once on CUDA rows that
    ``_check_rows`` (or, with ``elem_strides``, ``_check_strided``) passed,
    with the plan from ``n`` and the addresses."""
    if n == 0:
        return torch.zeros(rows, dtype=torch.float32, device=ins[0].device)
    inputs = _reduce_inputs(ins, rows, n, elem_strides)
    return _launch_one(kernel, ins[0].device, rows, reduce_plan(n, inputs),
                       [v for t in inputs for v in t] + [rows, n])


def _launch_one(kernel: str, dev: torch.device, rows: int, plan: ReducePlan,
                head) -> torch.Tensor:
    """Launch a one-launch kernel once on ``dev``: ``head`` is its C
    call's arguments before the plan; scratch from ``kernels._scratch``
    when a row takes more than one block, and only ``out`` allocated."""
    out = torch.empty(rows, dtype=torch.float32, device=dev)
    fn = _REDUCE_FNS.get(kernel)
    if fn is None:  # the first call builds and binds the library
        _lib()
        fn = _REDUCE_FNS[kernel]
    index = dev.index
    with (_SAME_DEVICE if index == torch.cuda.current_device()
          else torch.cuda.device(index)):
        # the stream's handle without building a Stream object
        stream = torch._C._cuda_getCurrentRawStream(index)
        partials = counts = None
        need = partials_needed(rows, plan)
        if need:
            partials, counts = last_block_scratch(index, stream, rows, need)
        err = fn(*head, plan.nparts, plan.vec, partials, counts,
                 out.data_ptr(), stream)
    if err:
        _raise_on(err, kernel)
    LAUNCHES[kernel] += 1
    return out


def std_normal_sum_rows(z: torch.Tensor) -> torch.Tensor:
    """``out[b] = sum_i(-z[b, i]^2 / 2 - log(2 pi) / 2)`` for ``z (B, n)``."""
    rows, n = z.shape
    _check_rows("z", z, rows, n)
    if _device_kind(z) == "cpu":
        return ref.std_normal_logpdf_sum_ref(z)
    return _reduce_rows("std_normal_sum", (z,), rows, n)


def bernoulli_logit_sum_rows(logits: torch.Tensor,
                             y: torch.Tensor) -> torch.Tensor:
    """``out[b] = sum_i(-softplus(-l[b, i]) - (1 - y[b, i]) l[b, i])`` for
    two ``(B, n)`` inputs; each may have row and element stride 0 (logreg's
    ``y`` is one row shared by the chains)."""
    return _strided_sum("bernoulli_logit_sum",
                        ref.bernoulli_logits_logpmf_sum_ref, ("logits", "y"),
                        logits, y)


def gamma_unnorm_sum_rows(x: torch.Tensor, am1: torch.Tensor,
                          rate: torch.Tensor) -> torch.Tensor:
    """``out[b] = sum_i(am1[b, i] log x[b, i] - rate[b, i] x[b, i])`` for
    three ``(B, n)`` inputs; each may have row stride 0."""
    rows, n = x.shape
    for name, t in (("x", x), ("am1", am1), ("rate", rate)):
        _check_rows(name, t, rows, n)
    if _device_kind(x, am1, rate) == "cpu":
        return ref.gamma_unnorm_logpdf_sum_ref(x, am1, rate)
    return _reduce_rows("gamma_unnorm_sum", (x, am1, rate), rows, n)


def categorical_group(c: int) -> int:
    """Lanes per item of the categorical kernel for ``c`` classes: the
    smallest of 4, 8, 16 and 32 that holds at most 8 classes a lane, or 0
    above ``SMALL_C`` (one warp per item, the classes in strides)."""
    for group in (4, 8, 16, 32):
        if c <= 8 * group:
            return group
    return 0


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
    if n == 0:
        return torch.zeros(rows, dtype=torch.float32, device=logits.device)
    group = categorical_group(c)
    if not group:  # one launch, each logit read once
        l_stride = logits.stride(0) if rows > 1 else 0
        plan = categorical_plan(n, c, logits.data_ptr(), l_stride)
        return _launch_one("categorical_logits_sum", logits.device, rows, plan,
                           [logits.data_ptr(), l_stride, labels.data_ptr(),
                            labels.stride(0) if rows > 1 else 0, rows, n, c])
    out = torch.empty(rows, dtype=torch.float32, device=logits.device)
    nparts = _num_parts(n, _THREADS // group)  # a group of lanes an item
    partials = torch.empty(rows * nparts, dtype=torch.float32,
                           device=logits.device)
    l_stride = logits.stride(0) if rows > 1 else n * c
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = _lib().repro_categorical_logits_sum_small(
            logits.data_ptr(), l_stride, labels.data_ptr(),
            _row_stride(labels), rows, n, c, group, partials.data_ptr(),
            nparts, out.data_ptr(), stream)
    _raise_on(err, "categorical_logits_sum_small")
    LAUNCHES["categorical_logits_sum_small"] += 1
    return out


def _check_strided(name: str, t: torch.Tensor, rows: int, n: int) -> None:
    """An input of the per-element kernels: ``(rows, n)`` float32 with any
    row stride and an element stride of 1 or 0 (one value for the row)."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected {torch.float32}, got {t.dtype}")
    if t.dim() != 2 or tuple(t.shape) != (rows, n):
        raise ValueError(f"{name}: expected shape {(rows, n)}, got "
                         f"{tuple(t.shape)}")
    if n > 1 and t.stride(1) not in (0, 1):
        raise ValueError(f"{name}: element stride must be 0 or 1, got "
                         f"{t.stride()}")


def _strided_sum(kernel: str, plain, names, *ins: torch.Tensor) -> torch.Tensor:
    """Launch one per-element row-sum kernel of ``fused_logpdf.cu``
    (normal's, beta's, student_t's or bernoulli's one launch) on ``(B, n)``
    inputs of any row stride and an element stride of 0 or 1, each passed
    as pointer, row stride, element stride; on CPU tensors run
    ``plain``."""
    rows, n = ins[0].shape
    for name, t in zip(names, ins):
        _check_strided(name, t, rows, n)
    if _device_kind(*ins) == "cpu":
        return plain(*ins)
    return _reduce_rows(kernel, ins, rows, n, elem_strides=True)


def normal_sum_rows(x: torch.Tensor, loc: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """``out[b] = sum_i(-z^2/2 - log scale[b, i] - log(2 pi)/2)`` with
    ``z = (x[b, i] - loc[b, i]) / scale[b, i]``, for three ``(B, n)``
    inputs; each may have row stride 0 and element stride 0."""
    return _strided_sum("normal_sum", ref.normal_logpdf_sum_ref,
                        ("x", "loc", "scale"), x, loc, scale)


def beta_unnorm_sum_rows(x: torch.Tensor, am1: torch.Tensor,
                         bm1: torch.Tensor) -> torch.Tensor:
    """``out[b] = sum_i(am1[b, i] log x[b, i] + bm1[b, i] log1p(-x[b, i]))``
    for three ``(B, n)`` inputs; each may have row and element stride 0."""
    return _strided_sum("beta_unnorm_sum", ref.beta_unnorm_logpdf_sum_ref,
                        ("x", "am1", "bm1"), x, am1, bm1)


def student_t_unnorm_sum_rows(z: torch.Tensor,
                              df: torch.Tensor) -> torch.Tensor:
    """``out[b] = sum_i(-(df[b, i] + 1)/2 log1p(z[b, i]^2 / df[b, i]))`` for
    two ``(B, n)`` inputs; each may have row and element stride 0."""
    return _strided_sum("student_t_unnorm_sum",
                        ref.student_t_unnorm_logpdf_sum_ref, ("z", "df"),
                        z, df)


def mvn_quadform_sum_rows(xc: torch.Tensor, prec: torch.Tensor) -> torch.Tensor:
    """``out[b] = -1/2 sum_n xc[b, n]^T prec[b] xc[b, n]`` for float32
    ``xc (B, N, D)`` (rows dense, batch stride N*D or 0) and ``prec (B, D,
    D)`` (row-major, batch stride D*D or 0: one precision shared by every
    b, or one per b)."""
    if xc.dim() != 3 or prec.dim() != 3:
        raise ValueError(f"expected xc (B, N, D) and prec (B, D, D), got "
                         f"{tuple(xc.shape)} and {tuple(prec.shape)}")
    rows, n, d = xc.shape
    if tuple(prec.shape) != (rows, d, d):
        raise ValueError(f"prec: expected shape {(rows, d, d)}, got "
                         f"{tuple(prec.shape)}")
    for name, t in (("xc", xc), ("prec", prec)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        inner = t.shape[1] * t.shape[2]
        if ((t.shape[2] > 1 and t.stride(2) != 1)
                or (t.shape[1] > 1 and t.stride(1) != t.shape[2])
                or (rows > 1 and t.stride(0) not in (0, inner))):
            raise ValueError(f"{name}: strides {t.stride()} not (dense or "
                             "0, D, 1)")
    if _device_kind(xc, prec) == "cpu":
        return ref.mvnormal_prec_quadform_sum_ref(xc, prec)
    if n >= 2 ** 31:
        raise ValueError(f"xc: {n} rows, more than the kernel indexes")
    out = torch.empty(rows, dtype=torch.float32, device=xc.device)
    if n == 0 or d == 0:
        return out.zero_()
    tiles = mvn_tiles(n, d)
    partials = torch.empty(rows * tiles, dtype=torch.float32,
                           device=xc.device)
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream(xc.device).cuda_stream
        counts = _mvn_counts(rows, xc.device, stream)
        err = _mvn_lib().repro_mvn_quadform_sum(
            xc.data_ptr(), xc.stride(0) if rows > 1 else 0, prec.data_ptr(),
            prec.stride(0) if rows > 1 else 0, rows, n, d,
            partials.data_ptr(), tiles, counts.data_ptr(), out.data_ptr(),
            stream)
    _raise_on(err, "mvn_quadform_sum")
    LAUNCHES["mvn_quadform_sum"] += 1
    return out


def mvn_tiles(n: int, d: int) -> int:
    """Blocks of one row of ``mvn_quadform_sum``: 128 rows of xc by 128
    columns of the precision (64 when ``d <= 64``), as ``mvn_quad.cu``
    cuts them."""
    width = 64 if d <= 64 else 128
    return -(-n // _MVN_ROWS) * -(-d // width)


def mvn_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one ``mvn_quadform_sum`` block (``Tile``'s
    kSmem in the source): three stages of a 128 x 36 xc tile and a width x
    36 tile of the precision's rows, float32."""
    width = 64 if d <= 64 else 128
    return 3 * (_MVN_ROWS + width) * 36 * 4


def _mvn_counts(rows: int, device: torch.device, stream: int) -> torch.Tensor:
    """At least ``rows`` zero int32 counts for mvn_quadform_sum's last-block
    sum on this device and stream (calls on one stream run one at a
    time)."""
    key = (device, stream)
    counts = _MVN_COUNTS.get(key)
    if counts is None or counts.numel() < rows:
        counts = torch.zeros(max(rows, 1024), dtype=torch.int32,
                             device=device)
        _MVN_COUNTS[key] = counts
    return counts


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
        return _elementwise_forward(bernoulli_logit_sum_rows, logits, y)

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
        return _BernoulliLogitSum.apply(*_batch_front((logits, y), in_dims)), 0


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
        return _GammaUnnormSum.apply(*_batch_front((x, am1, rate), in_dims)), 0


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


def _strided_rows(t: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    """View ``t`` broadcast to ``shape`` as ``(B, n)`` rows for the
    per-element kernels, which read any row stride and an element stride of
    0 or 1: a broadcast scalar per row (one mu per chain) stays a view.
    Each step runs only where it changes something (each is a dispatch on
    every evaluation)."""
    if t.dtype != torch.float32:
        t = t.to(torch.float32)
    if len(shape) == 2:
        rows = t if t.shape == shape else t.expand(shape)
    else:
        shape = shape if len(shape) else torch.Size([1])
        rows = t.expand(shape).reshape(-1, shape[-1])
    if shape[-1] > 1 and rows.stride(1) not in (0, 1):
        rows = rows.contiguous()
    return rows


def _batch_front(args, in_dims):
    """A ``vmap`` rule's inputs with the batch axis in front and each
    batched input's logical rank padded with 1s up to the largest logical
    rank, so that it broadcasts against the unbatched ones as its logical
    shape would: a per-chain scalar ``mu`` beside shared data ``x (n,)``
    becomes ``(B, 1)``."""
    rank = max(t.dim() - (d is not None) for t, d in zip(args, in_dims))
    out = []
    for t, d in zip(args, in_dims):
        if d is not None:
            if d != 0:
                t = t.movedim(d, 0)
            if t.dim() < rank + 1:
                t = t.reshape(t.shape[:1] + (1,) * (rank + 1 - t.dim())
                              + t.shape[1:])
        out.append(t)
    return out


def _elementwise_forward(rows_fn, *ins):
    shape = torch.broadcast_shapes(*(t.shape for t in ins))
    out = rows_fn(*(_strided_rows(t, shape) for t in ins))
    return out if len(shape) == 2 else out.reshape(shape[:-1])


class _NormalSum(torch.autograd.Function):
    """``sum(-z^2/2 - log scale - log(2 pi)/2)``, ``z = (x - loc)/scale``,
    over the last axis; analytic backward ``dx = -g z/scale``, ``dloc = g
    z/scale``, ``dscale = g (z^2 - 1)/scale`` (the JAX package's
    ``ops.py:166``)."""

    @staticmethod
    def forward(x, loc, scale):
        return _elementwise_forward(normal_sum_rows, x, loc, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        x, loc, scale = ctx.saved_tensors
        g = g.unsqueeze(-1)
        z = (x - loc) / scale
        dx = dloc = dscale = None
        if ctx.needs_input_grad[0]:
            dx = (g * (-z / scale)).sum_to_size(x.shape)
        if ctx.needs_input_grad[1]:
            dloc = (g * (z / scale)).sum_to_size(loc.shape)
        if ctx.needs_input_grad[2]:
            dscale = (g * ((z * z - 1.0) / scale)).sum_to_size(scale.shape)
        return dx, dloc, dscale

    @staticmethod
    def vmap(info, in_dims, x, loc, scale):
        return _NormalSum.apply(*_batch_front((x, loc, scale), in_dims)), 0


class _BetaUnnormSum(torch.autograd.Function):
    """``sum(am1 log x + bm1 log1p(-x))`` over the last axis; analytic
    backward ``dx = g (am1/x - bm1/(1 - x))``, ``dam1 = g log x``, ``dbm1
    = g log1p(-x)`` (the JAX package's ``ops.py:376``)."""

    @staticmethod
    def forward(x, am1, bm1):
        return _elementwise_forward(beta_unnorm_sum_rows, x, am1, bm1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        x, am1, bm1 = ctx.saved_tensors
        g = g.unsqueeze(-1)
        dx = dam1 = dbm1 = None
        if ctx.needs_input_grad[0]:
            dx = (g * (am1 / x - bm1 / (1.0 - x))).sum_to_size(x.shape)
        if ctx.needs_input_grad[1]:
            dam1 = (g * torch.log(x)).sum_to_size(am1.shape)
        if ctx.needs_input_grad[2]:
            dbm1 = (g * torch.log1p(-x)).sum_to_size(bm1.shape)
        return dx, dam1, dbm1

    @staticmethod
    def vmap(info, in_dims, x, am1, bm1):
        return _BetaUnnormSum.apply(*_batch_front((x, am1, bm1), in_dims)), 0


class _StudentTUnnormSum(torch.autograd.Function):
    """``sum(-(df + 1)/2 log1p(z^2/df))`` over the last axis; analytic
    backward ``dz = -g (df + 1) z/(df + z^2)``, ``ddf = g (-log1p(z^2/df)/2
    + (df + 1) z^2 / (2 df (df + z^2)))`` (the JAX package's
    ``ops.py:426``)."""

    @staticmethod
    def forward(z, df):
        return _elementwise_forward(student_t_unnorm_sum_rows, z, df)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        z, df = ctx.saved_tensors
        g = g.unsqueeze(-1)
        z2 = z * z
        dz = ddf = None
        if ctx.needs_input_grad[0]:
            dz = (g * (-(df + 1.0) * z / (df + z2))).sum_to_size(z.shape)
        if ctx.needs_input_grad[1]:
            ddf = (g * (-0.5 * torch.log1p(z2 / df)
                        + 0.5 * (df + 1.0) * z2 / (df * (df + z2))))
            ddf = ddf.sum_to_size(df.shape)
        return dz, ddf

    @staticmethod
    def vmap(info, in_dims, z, df):
        return _StudentTUnnormSum.apply(*_batch_front((z, df), in_dims)), 0


class _MvnQuadformSum(torch.autograd.Function):
    """``-1/2 sum_n xc_n^T P xc_n`` over the last two axes of ``xc (..., N,
    D)`` with ``P (..., D, D)``; analytic backward ``dxc = -g/2 xc (P +
    P^T)``, ``dP = -g/2 xc^T xc`` (the JAX package's ``ops.py:485``; the
    two products are plain matmuls, as there)."""

    @staticmethod
    def forward(xc, prec):
        n, d = xc.shape[-2:]
        lead = torch.broadcast_shapes(xc.shape[:-2], prec.shape[:-2])
        out = mvn_quadform_sum_rows(
            _addressable(xc.to(torch.float32).expand(lead + (n, d))
                         .reshape(-1, n, d)),
            _addressable(prec.to(torch.float32).expand(lead + (d, d))
                         .reshape(-1, d, d)))
        return out.reshape(lead)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        xc, prec = ctx.saved_tensors
        g = -0.5 * g[..., None, None]
        dxc = dprec = None
        if ctx.needs_input_grad[0]:
            dxc = (g * (xc @ (prec + prec.mT))).sum_to_size(xc.shape)
        if ctx.needs_input_grad[1]:
            dprec = (g * (xc.mT @ xc)).sum_to_size(prec.shape)
        return dxc, dprec

    @staticmethod
    def vmap(info, in_dims, xc, prec):
        # P shared by the chains stays unbatched and is read at stride 0
        return _MvnQuadformSum.apply(*_batch_front((xc, prec), in_dims)), 0


def _like(v, x: torch.Tensor) -> torch.Tensor:
    """A parameter as float32 on ``x``'s device. A Python number (or a CPU
    scalar beside a CUDA ``x``) becomes a device fill, not a host-to-device
    copy, so no evaluation waits for the stream."""
    if not torch.is_tensor(v):
        return torch.full((), float(v), dtype=torch.float32, device=x.device)
    if v.device == x.device:
        return v.to(torch.float32)
    if (v.dim() == 0 and not v.requires_grad
            and not torch._C._functorch.is_functorch_wrapped_tensor(v)):
        return torch.full((), float(v), dtype=torch.float32, device=x.device)
    return v.to(device=x.device, dtype=torch.float32)


def std_normal_logpdf_sum(z: torch.Tensor, *, block_rows: int = 256,
                          interpret: Optional[bool] = None) -> torch.Tensor:
    """``sum(StdNormal.log_prob(z))`` over the last axis, differentiable.
    ``block_rows`` is ignored; ``interpret=True`` runs the plain version
    (``kernels._dispatch``)."""
    z = torch.as_tensor(z, dtype=torch.float32)
    if plain_requested(interpret=interpret):
        return ref.std_normal_logpdf_sum_ref(z)
    return _StdNormalSum.apply(z)


def bernoulli_logits_logpmf_sum(logits: torch.Tensor, y: torch.Tensor, *,
                                block_rows: int = 256,
                                interpret: Optional[bool] = None
                                ) -> torch.Tensor:
    """``sum(y log sigmoid(l) + (1-y) log sigmoid(-l))`` over the last
    axis, differentiable in ``logits`` and ``y``. ``block_rows`` is
    ignored; ``interpret=True`` runs the plain version."""
    logits = torch.as_tensor(logits, dtype=torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32)
    if plain_requested(interpret=interpret):
        return ref.bernoulli_logits_logpmf_sum_ref(logits, y)
    return _BernoulliLogitSum.apply(logits, y)


def gamma_unnorm_logpdf_sum(x: torch.Tensor, am1: torch.Tensor,
                            rate: torch.Tensor, *, block_rows: int = 256,
                            interpret: Optional[bool] = None
                            ) -> torch.Tensor:
    """``sum(am1 log x - rate x)`` over the last axis (the Gamma normaliser
    ``a log b - lgamma(a)`` stays with the caller), differentiable in all
    three. ``block_rows`` is ignored; ``interpret=True`` runs the plain
    version."""
    ins = tuple(torch.as_tensor(t, dtype=torch.float32)
                for t in (x, am1, rate))
    if plain_requested(interpret=interpret):
        return ref.gamma_unnorm_logpdf_sum_ref(*ins)
    return _GammaUnnormSum.apply(*ins)


def categorical_logits_logpmf_sum(logits: torch.Tensor, labels: torch.Tensor,
                                  *, block_rows: int = 128,
                                  interpret: Optional[bool] = None
                                  ) -> torch.Tensor:
    """``sum_n log softmax(logits_n)[labels_n]`` over the item axis of
    ``logits (..., N, C)`` with int32 ``labels (..., N)``, differentiable
    in ``logits``. ``block_rows`` is ignored; ``interpret=True`` runs the
    plain version."""
    labels = torch.as_tensor(labels)
    if labels.dtype != torch.int32:
        labels = labels.to(torch.int32)
    logits = torch.as_tensor(logits, dtype=torch.float32)
    if plain_requested(interpret=interpret):
        return ref.categorical_logits_logpmf_sum_ref(logits, labels)
    return _CategoricalLogitsSum.apply(logits, labels)


def normal_logpdf_sum(x: torch.Tensor, loc, scale, *, block_rows: int = 256,
                      interpret: Optional[bool] = None) -> torch.Tensor:
    """``sum(Normal(loc, scale).log_prob(x))`` over the last axis of the
    broadcast shape, differentiable in all three. ``loc`` and ``scale`` may
    be Python numbers or tensors broadcastable against ``x``; a scalar per
    chain under ``vmap`` is read at element stride 0, not materialised.
    ``block_rows`` is ignored; ``interpret=True`` runs the plain version."""
    x = torch.as_tensor(x, dtype=torch.float32)
    if plain_requested(interpret=interpret):
        return ref.normal_logpdf_sum_ref(x, _like(loc, x), _like(scale, x))
    return _NormalSum.apply(x, _like(loc, x), _like(scale, x))


def beta_unnorm_logpdf_sum(x: torch.Tensor, am1, bm1, *,
                           block_rows: int = 256,
                           interpret: Optional[bool] = None) -> torch.Tensor:
    """``sum(am1 log x + bm1 log1p(-x))`` over the last axis (the log-beta
    normaliser stays with the caller), differentiable in all three; ``x``
    must lie in (0, 1). ``block_rows`` is ignored; ``interpret=True`` runs
    the plain version."""
    x = torch.as_tensor(x, dtype=torch.float32)
    if plain_requested(interpret=interpret):
        return ref.beta_unnorm_logpdf_sum_ref(x, _like(am1, x), _like(bm1, x))
    return _BetaUnnormSum.apply(x, _like(am1, x), _like(bm1, x))


def student_t_unnorm_logpdf_sum(z: torch.Tensor, df, *,
                                block_rows: int = 256,
                                interpret: Optional[bool] = None
                                ) -> torch.Tensor:
    """``sum(-(df + 1)/2 log1p(z^2/df))`` over the last axis on standardised
    ``z`` (the lgamma and log-scale normaliser stays with the caller),
    differentiable in both. ``block_rows`` is ignored; ``interpret=True``
    runs the plain version."""
    z = torch.as_tensor(z, dtype=torch.float32)
    if plain_requested(interpret=interpret):
        return ref.student_t_unnorm_logpdf_sum_ref(z, _like(df, z))
    return _StudentTUnnormSum.apply(z, _like(df, z))


def mvnormal_prec_quadform_sum(xc: torch.Tensor, prec: torch.Tensor, *,
                               block_rows: int = 256,
                               interpret: Optional[bool] = None
                               ) -> torch.Tensor:
    """``-1/2 sum_n xc_n^T P xc_n`` for centred rows ``xc (..., N, D)`` and
    a dense precision ``P (..., D, D)`` (assumed symmetric), one launch;
    the ``-N (sum log diag L + D/2 log 2 pi)`` normaliser stays with the
    caller. Differentiable in both. ``block_rows`` is ignored;
    ``interpret=True`` runs the plain version."""
    xc = torch.as_tensor(xc, dtype=torch.float32)
    if plain_requested(interpret=interpret):
        return ref.mvnormal_prec_quadform_sum_ref(xc, _like(prec, xc))
    return _MvnQuadformSum.apply(xc, _like(prec, xc))


def site_block_sum(family: str, segments: Sequence[Tuple], *,
                   use_pallas: Optional[bool] = None,
                   interpret: Optional[bool] = None) -> torch.Tensor:
    """Sum the log-densities of all same-family site segments in ONE launch.

    Parameters
    ----------
    family : str
        One of ``SITE_BLOCK_FAMILIES``:

        * ``"std_normal"`` — segments ``(z,)``, 1-D standardised values
          (the ``-sum(log scale)`` term stays with the caller);
        * ``"normal"`` — segments ``(x, loc, scale)``, each 1-D;
        * ``"bernoulli_logits"`` — segments ``(logits, y)``, each 1-D;
        * ``"categorical_logits"`` — segments ``(logits (N_i, C), labels
          (N_i,))`` with int32 labels, all of one ``C``;
        * ``"gamma"`` — segments ``(x, a - 1, rate)``, each 1-D (``a log b
          - lgamma(a)`` stays with the caller);
        * ``"beta"`` — segments ``(x, a - 1, b - 1)``, each 1-D (the
          log-beta normaliser stays with the caller);
        * ``"student_t"`` — segments ``(z, df)``, 1-D standardised values
          (the lgamma and log-scale normaliser stays with the caller);
        * ``"mvnormal_prec"`` — segments ``(xc (N_i, D), prec (D, D))``;
          each keeps its own precision, so each segment is one launch.
    segments : sequence of tuples of tensors
        Per-site flattened blocks as above.
    use_pallas, interpret : bool, optional
        The JAX package's switches: ``use_pallas=False`` or
        ``interpret=True`` runs the plain version (``kernels._dispatch``);
        ``None`` launches the kernel on a CUDA tensor.

    Returns
    -------
    torch.Tensor, scalar float32
        ``sum_i sum(logpdf(segment_i))``, differentiable in the segments
        (analytic backward) and batched over chains under ``vmap``.
    """
    if family not in SITE_BLOCK_FAMILIES:
        raise ValueError(f"unknown site-block family '{family}'; "
                         f"expected one of {SITE_BLOCK_FAMILIES}")
    if not segments:
        return torch.zeros((), dtype=torch.float32)
    kw = {"interpret": plain_requested(use_pallas, interpret)}
    if family == "mvnormal_prec":
        total = mvnormal_prec_quadform_sum(*segments[0], **kw)
        for xc, prec in segments[1:]:
            total = total + mvnormal_prec_quadform_sum(xc, prec, **kw)
        return total
    if len(segments) == 1:
        cols = segments[0]
    else:
        cols = tuple(torch.cat(parts, dim=0) for parts in zip(*segments))
    if family == "std_normal":
        (z,) = cols
        return std_normal_logpdf_sum(z, **kw)
    if family == "normal":
        return normal_logpdf_sum(*cols, **kw)
    if family == "gamma":
        return gamma_unnorm_logpdf_sum(*cols, **kw)
    if family == "beta":
        return beta_unnorm_logpdf_sum(*cols, **kw)
    if family == "student_t":
        return student_t_unnorm_logpdf_sum(*cols, **kw)
    if family == "categorical_logits":
        return categorical_logits_logpmf_sum(*cols, **kw)
    logits, y = cols
    return bernoulli_logits_logpmf_sum(logits, y, **kw)
