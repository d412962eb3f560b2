"""Public wrapper of the SSD scan kernels.

``ssd_scan(x, dt, A, B, C, chunk)`` takes the JAX package's layout. On a
CUDA tensor it launches one of the hand-written kernels in
``csrc/ssd_scan.cu`` (or raises); on a CPU tensor it runs the plain
version in ``ref.py``. Nothing falls back. ``plan`` picks the kernel from
the shapes, the type and the alignment alone, so reruns take the same
path:

* ``ssd_scan_tc`` for bf16 x, B and C with chunk, d_state and head dim
  each 64 or 128, the block's 128 / p heads in one group, and 16-byte
  aligned rows: the four chunk products on the tensor cores;
* ``ssd_scan_tf32`` for float32 x, B and C with d_state and head dim
  each 64 or 128, any chunk of ``CHUNKS`` (it walks sub-chunks of 64
  whatever the chunk) and 16-byte aligned rows: the four products on the
  tensor cores in 3xTF32 (float32 accuracy), C B^T formed once for a
  group's heads by a pre-pass into scratch the wrapper allocates;
* ``ssd_scan`` for everything else: FP32 on the CUDA cores, for head dim
  32, other state dims and unaligned rows in either type, and bf16 calls
  at chunk 32 or whose heads do not fill ``ssd_scan_tc``'s blocks.

Each call that reaches the card is counted once in ``LAUNCHES`` under its
kernel's name (``ssd_scan_tf32``'s pre-pass is part of the same call).

The kernels read x, B and C through their strides (the last axis must be
dense: the mixer's split views of the convolution output go in as they
are) and treat the positions past the sequence as dt = 0, as the JAX
wrapper's padding does, so nothing is padded or copied. The
``torch.autograd.Function``'s backward recomputes through the plain
version, as the JAX package's ``_ssd_bwd`` does.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels._build import KernelError, load_library
from repro_torch.kernels._dispatch import plain_requested
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

__all__ = ["LAUNCHES", "reset_launch_counts", "ssd_scan", "kernel_source",
           "CHUNKS", "HEAD_DIMS", "smem_bytes", "MAX_SMEM_BYTES", "KERNELS",
           "plan", "tc_aligned", "launch_kernel", "TC_CHUNKS",
           "TC_HEAD_DIMS", "TC_STATE_DIMS"]

KERNELS = ("ssd_scan", "ssd_scan_tc", "ssd_scan_tf32")
# launches since the last reset, by kernel (one per call that reached the
# card)
LAUNCHES = dict.fromkeys(KERNELS, 0)
CHUNKS = (32, 64, 128)      # the FP32 kernel's chunk lengths
HEAD_DIMS = (32, 64, 128)   # and head dims p
TC_CHUNKS = (64, 128)       # the tensor-core kernels' chunk lengths,
TC_HEAD_DIMS = (64, 128)    # head dims p
TC_STATE_DIMS = (64, 128)   # and state dims n
_TC_COLS = 128              # ssd_scan_tc's output columns a block (heads x p)
_TF_ROWS = 64               # ssd_scan_tf32's sub-chunk (positions)
_TF_COLS = 64               # and output columns a block
MAX_SMEM_BYTES = 232_448    # shared memory one block may use on Hopper
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LIB = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_source() -> Path:
    return Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"


def smem_bytes(chunk: int, n: int, p: int, kernel: str = "ssd_scan") -> int:
    """Shared memory of one block of ``kernel``.

    ``ssd_scan`` (``smem_floats`` in the source): C and B ``[chunk][n +
    1]``, x ``[chunk][p]``, S ``[n][p]``, one 32-row weight tile ``[32][chunk
    + 1]`` and three chunk vectors, in float32. ``ssd_scan_tc``
    (``TcShape::kSmem``): two stages of C and B ``[chunk][n]`` and x
    ``[chunk][128]`` and S ``[n][128]`` in bf16, cum and dt ``[2][chunk]`` in
    float32 (its 128 columns are 128 / p heads). ``ssd_scan_tf32``
    (``TfShape::kSmem``, whatever the chunk and p): two stages of C and B
    ``[64][n]``, x ``[64][64]`` and dt ``[64]``, S's hi and lo ``[n][64]``,
    cum and segdt ``[64]``, in float32."""
    if kernel == "ssd_scan_tc":
        return 2 * (2 * (2 * chunk * n + chunk * _TC_COLS) + n * _TC_COLS) \
            + 4 * 2 * 2 * chunk
    if kernel == "ssd_scan_tf32":
        stage = 2 * _TF_ROWS * n + _TF_ROWS * _TF_COLS + _TF_ROWS
        return 4 * (2 * stage + 2 * n * _TF_COLS + 2 * _TF_ROWS)
    return 4 * (2 * chunk * (n + 1) + chunk * p + n * p + 32 * (chunk + 1)
                + 3 * chunk + 1)


def plan(h: int, g: int, p: int, n: int, chunk: int,
         dtype: torch.dtype = torch.bfloat16, aligned: bool = True) -> str:
    """The kernel (one of ``KERNELS``) of one call from its shapes, type
    and alignment alone, so reruns take the same path: ``ssd_scan_tc`` for
    bf16 at chunk, n and p in (64, 128), with a block's 128 / p heads in
    one group and ``aligned`` rows (``tc_aligned``); ``ssd_scan_tf32`` for
    float32 at n and p in (64, 128), any chunk of ``CHUNKS``, with
    ``aligned`` rows (mamba2's float32 scoring call); else the FP32
    ``ssd_scan``, which keeps head dim 32, state dims other than 64 and
    128 and unaligned rows in either type, and bf16 calls at chunk 32 or
    whose heads do not fill ``ssd_scan_tc``'s blocks."""
    tc_shape = (aligned and p in TC_HEAD_DIMS and n in TC_STATE_DIMS
                and g > 0 and h % g == 0)
    if (tc_shape and dtype == torch.bfloat16 and chunk in TC_CHUNKS
            and (h // g) % (_TC_COLS // p) == 0):
        return "ssd_scan_tc"
    if tc_shape and dtype == torch.float32 and chunk in CHUNKS:
        return "ssd_scan_tf32"
    return "ssd_scan"


def tc_aligned(*ts: torch.Tensor) -> bool:
    """Whether the tensor-core kernels' 16-byte copies can read each
    tensor: a 16-byte aligned base, a dense last axis and every other
    stride a whole number of 16-byte chunks (8 bf16, 4 float32)."""
    return all(t.data_ptr() % 16 == 0
               and (t.shape[-1] <= 1 or t.stride(-1) == 1)
               and all(st % (16 // t.element_size()) == 0 for size, st in
                       zip(t.shape[:-1], t.stride()[:-1]) if size > 1)
               for t in ts)


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = load_library(kernel_source())
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.repro_ssd_scan.argtypes = [p] * 6 + [i32] + [i64] * 14 + \
            [i32] * 7 + [p]
        lib.repro_ssd_scan.restype = i32
        lib.repro_ssd_scan_tc.argtypes = [p] * 6 + [i64] * 14 + [i32] * 7 \
            + [p]
        lib.repro_ssd_scan_tc.restype = i32
        lib.repro_ssd_scan_tf32.argtypes = [p] * 7 + [i64] * 14 + \
            [i32] * 7 + [p]
        lib.repro_ssd_scan_tf32.restype = i32
        lib.repro_ssd_cuda_error_string.argtypes = [i32]
        lib.repro_ssd_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def launch_kernel(kernel: str, x, dt, A, B, C, *, chunk: int = 128
                  ) -> torch.Tensor:
    """Run one named kernel of ``KERNELS`` on CUDA tensors, whatever
    ``plan`` would pick (raises where that kernel does not take the call):
    for holding the kernels against the plain version and against each
    other. The model path goes through ``ssd_scan``, which follows
    ``plan``. No autograd."""
    if kernel not in KERNELS:
        raise ValueError(f"ssd_scan: no kernel {kernel!r}; one of {KERNELS}")
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: {kernel} runs on a CUDA tensor, got "
                         f"'{x.device.type}'")
    return _launch(x, dt, A, B, C, chunk, kernel)


def _launch(x, dt, A, B, C, chunk: int,
            kernel: Optional[str] = None) -> torch.Tensor:
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_scan: x, B, C must share float32 or bfloat16, "
                        f"got {x.dtype}, {B.dtype}, {C.dtype}")
    if h % g:
        raise ValueError(f"ssd_scan: {h} heads over {g} groups")
    chosen = plan(h, g, p, n, chunk, x.dtype, tc_aligned(x, B, C))
    if kernel is None:
        kernel = chosen
    elif kernel != "ssd_scan" and chosen != kernel:
        raise ValueError(f"{kernel} does not take this call: {x.dtype}, "
                         f"chunk {chunk}, h {h}, g {g}, p {p}, n {n}, "
                         f"aligned {tc_aligned(x, B, C)}")
    if kernel == "ssd_scan" and (chunk not in CHUNKS or p not in HEAD_DIMS):
        raise ValueError(f"ssd_scan: the kernel takes chunk in {CHUNKS} and "
                         f"head dim in {HEAD_DIMS}, got {chunk} and {p}")
    if kernel == "ssd_scan" and smem_bytes(chunk, n, p) > MAX_SMEM_BYTES:
        raise ValueError(f"ssd_scan: chunk {chunk}, d_state {n}, head dim "
                         f"{p} need {smem_bytes(chunk, n, p)} B of shared "
                         f"memory, more than {MAX_SMEM_BYTES}")
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    if s == 0 or b == 0:
        return y
    dt = dt.to(torch.float32)
    A = A.to(torch.float32).contiguous()
    for name, t in (("x", x), ("B", B), ("C", C), ("dt", dt)):
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"ssd_scan: {name}'s last axis must be dense, "
                             f"strides {t.stride()}")
    strides = (x.stride(0), x.stride(1), x.stride(2),
               dt.stride(0), dt.stride(1),
               B.stride(0), B.stride(1), B.stride(2),
               C.stride(0), C.stride(1), C.stride(2),
               y.stride(0), y.stride(1), y.stride(2))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptrs = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), y.data_ptr())
        if kernel == "ssd_scan_tf32":  # G = C B^T of every sub-chunk
            gram = torch.empty(b * g * -(-s // _TF_ROWS) * _TF_ROWS ** 2,
                               dtype=torch.float32, device=x.device)
            err = _lib().repro_ssd_scan_tf32(*ptrs, gram.data_ptr(),
                                             *strides, b, s, h, g, n, p,
                                             chunk, stream)
        elif kernel == "ssd_scan_tc":
            err = _lib().repro_ssd_scan_tc(*ptrs, *strides, b, s, h, g, n, p,
                                           chunk, stream)
        else:
            err = _lib().repro_ssd_scan(*ptrs, _DTYPES[x.dtype], *strides,
                                        b, s, h, g, n, p, chunk, stream)
    if err != 0:
        msg = _lib().repro_ssd_cuda_error_string(err).decode()
        raise KernelError(f"{kernel} launch failed: CUDA error {err} ({msg}) "
                          f"for x {tuple(x.shape)}, B {tuple(B.shape)}")
    LAUNCHES[kernel] += 1
    return y


class _SSDScan(torch.autograd.Function):
    """Forward through the kernel (the plain version on a CPU tensor);
    backward by recomputing the plain version, as ``_ssd_bwd`` does. In
    ``torch.func``'s form (``setup_context``), so that ``torch.func.grad``
    runs through it, and its backward is a ``torch.func.vjp`` of the plain
    version, which nests under an outer transform."""

    @staticmethod
    def forward(x, dt, A, B, C, chunk):
        if x.device.type == "cpu":
            return ssd_scan_ref(x, dt, A, B, C, chunk=chunk)
        if x.device.type != "cuda":
            raise ValueError(f"no ssd_scan kernel for device "
                             f"'{x.device.type}'")
        return _launch(x, dt, A, B, C, chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:5])
        ctx.chunk = inputs[5]

    @staticmethod
    def backward(ctx, g):
        chunk = ctx.chunk
        _, vjp = torch.func.vjp(
            lambda *ins: ssd_scan_ref(*ins, chunk=chunk), *ctx.saved_tensors)
        grads = vjp(g)
        return tuple(d if need else None for d, need in
                     zip(grads, ctx.needs_input_grad[:5])) + (None,)


def ssd_scan(x, dt, A, B, C, *, chunk: int = 128,
             interpret: Optional[bool] = None):
    """Chunked SSD scan. x: (b,s,h,p); dt: (b,s,h) float32; A: (h,)
    float32; B, C: (b,s,g,n) -> y (b,s,h,p) in x's type.

    A sequence that is not a chunk multiple is scanned as if padded with
    dt = 0 (zero decay and zero state update); the padding is not
    returned. ``interpret=True`` runs the plain version
    (``kernels._dispatch``)."""
    if plain_requested(interpret=interpret):
        return ssd_scan_ref(x, dt, A, B, C, chunk=chunk)
    return _SSDScan.apply(x, dt, A, B, C, chunk)
