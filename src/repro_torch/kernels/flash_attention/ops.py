"""Public wrapper of the flash-attention kernels.

``flash_attention_gqa`` takes the JAX package's layout, q (B,Sq,KV,G,hd)
and k, v (B,Sk,KV,hd), with absolute positions for both and an optional
kv validity mask. On a CUDA tensor it launches one of the hand-written
kernels in ``csrc/flash_attention.cu`` (or raises); on a CPU tensor, or
when the caller passes ``interpret=True``, it runs the plain version in
``ref.py``. Nothing falls back. ``plan`` picks the kernel from the shapes,
the type and the head dim alone:

* ``flash_decode`` when there are fewer than 64 rows (Sq * G, decode), in
  either type: bound by the cache's bytes;
* ``flash_fwd_tc`` for bf16 prefill at hd 64 or 128: the tensor cores;
* ``flash_fwd_tf32`` for float32 prefill at hd 64 or 128: the tensor
  cores in 3xTF32 (float32 accuracy);
* ``flash_fwd`` for the prefill at every other head dim up to 256 (16,
  20, 256, ...), in either type: FP32 on the CUDA cores.

Each launch is counted in ``LAUNCHES`` under its kernel's name.

The kernels read q, k and v through their strides (the last axis must be
dense) and mask ragged lengths themselves, so the wrapper pads and copies
nothing, except that the tensor-core kernels' 16-byte copies need
16-byte aligned rows (a view that breaks that is copied first). A call with few
blocks splits its keys (``plan``): the wrapper then allocates the
partials' scratch, and the splits are merged in a fixed order, by the
source's combine kernel (a second launch within the same call) after the
prefill kernels, and by the last split to finish inside ``flash_decode``
(integer counts kept per device and stream, zero between calls). The ``torch.autograd.Function``'s backward
recomputes attention through the plain version, as the JAX package's
``_flash_bwd`` does (no attention matrix is kept from the forward).
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels._build import KernelError, load_library
from repro_torch.kernels._dispatch import plain_requested
from repro_torch.kernels._scratch import last_block_scratch
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["LAUNCHES", "reset_launch_counts", "flash_attention_gqa",
           "kernel_source", "plan", "Plan", "KERNELS", "MAX_HEAD_DIM",
           "decode_pass_keys", "launch_kernel", "smem_bytes",
           "MAX_SMEM_BYTES"]

KERNELS = ("flash_fwd", "flash_fwd_tc", "flash_decode", "flash_fwd_tf32")
# launches since the last reset, by kernel (one per call that reached the
# card; a split's combine is part of the same call)
LAUNCHES = dict.fromkeys(KERNELS, 0)
MAX_HEAD_DIM = 256
_SMS = 132        # streaming multiprocessors of an H100 SXM
_KEY_TILE = 64    # keys per tile of the prefill kernels
_DECODE_ROWS = 64  # fewer rows than this (Sq * G) go to flash_decode
_TC_HEAD_DIMS = (64, 128)
MAX_SMEM_BYTES = 232_448  # shared memory one block may use on Hopper
_STATE_CHUNK = 512        # tile states a tensor-core block holds at once
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LIB = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_source() -> Path:
    return Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = load_library(kernel_source())
        p, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_float)
        lib.repro_flash_attention.argtypes = (
            [i32] + [p] * 4 + [i32] + [p] * 3 + [i64] * 15 + [i32] * 8
            + [f32, f32] + [i32, i32] + [p] * 6)
        lib.repro_flash_attention.restype = i32
        lib.repro_flash_cuda_error_string.argtypes = [i32]
        lib.repro_flash_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


class Plan(NamedTuple):
    kernel: str   # one of KERNELS
    rows: int     # rows (query position x query head) per block
    nsplit: int   # key splits per row tile (> 1: a combine launch follows)


def plan(batch: int, sq: int, sk: int, kv_heads: int, group: int,
         dtype: torch.dtype = torch.bfloat16, head_dim: int = 64) -> Plan:
    """The kernel, rows per block and key splits of one call, from the
    shapes, type and head dim alone (so reruns take the same path).

    Fewer than 64 rows (Sq * G): ``flash_decode``, R rows per block (the
    power of two >= the rows, at most 8), the keys split into as many
    blocks as the card holds at once (three an SM, two at R = 8: one
    wave, which fills the 132 SMs at least twice) but no more splits than
    give each block two passes of its key groups (``decode_pass_keys``).
    Otherwise, at hd 64 or 128, ``flash_fwd_tc`` for bf16 and
    ``flash_fwd_tf32`` for float32 (the float32 gates' prefill: smollm's hd
    64, gemma2's 128); at any other head dim ``flash_fwd`` in either type.
    64 rows per block, and when those blocks are fewer than the SMs the
    key tiles are split so that about 4 blocks per SM run, at most one
    split per tile."""
    rows = sq * group
    if rows < _DECODE_ROWS:
        r = 1
        while r < min(rows, 8):
            r *= 2
        blocks = -(-rows // r) * kv_heads * batch
        resident = (3 if r <= 4 else 2) * _SMS
        passes = -(-sk // (2 * decode_pass_keys(r, head_dim, dtype)))
        return Plan("flash_decode", r,
                    max(1, min(passes, resident // blocks)))
    kernel = "flash_fwd"
    if head_dim in _TC_HEAD_DIMS:
        kernel = ("flash_fwd_tc" if dtype == torch.bfloat16
                  else "flash_fwd_tf32")
    blocks = -(-rows // 64) * kv_heads * batch
    if blocks >= _SMS:
        return Plan(kernel, 64, 1)
    return Plan(kernel, 64, max(1, min(-(-sk // _KEY_TILE),
                                       -(-4 * _SMS // blocks))))


def smem_bytes(kernel: str, head_dim: int) -> int:
    """Shared memory of one block of a tensor-core prefill kernel, dynamic
    and static (the tile states): ``flash_fwd_tc`` (``tc_smem_bytes`` in
    the source) two stages of bf16 K and V tiles and their positions;
    ``flash_fwd_tf32`` (``tf_smem_bytes``) one tile's K and V fragments,
    hi and lo, one raw float32 tile of K and V (rows of hd + 4) and two
    sets of positions."""
    if kernel == "flash_fwd_tc":
        dynamic = 2 * 2 * _KEY_TILE * head_dim * 2 + 2 * _KEY_TILE * 4
    elif kernel == "flash_fwd_tf32":
        dynamic = 4 * (4 * _KEY_TILE * head_dim
                       + 2 * _KEY_TILE * (head_dim + 4)) + 2 * _KEY_TILE * 4
    else:
        raise ValueError(f"no shared-memory reckoning for {kernel!r}")
    return dynamic + _STATE_CHUNK


def _strides(t: torch.Tensor, group: Optional[int] = None):
    """(batch, sequence, head) strides as the kernels read them: q and out
    (B,Sq,KV,G,hd) as (B,Sq,KV*G,hd) with head h = kv * G + g (the caller
    makes (KV, G) one axis), k and v (B,Sk,KV,hd). A stride of an axis of
    size 1 is given as 0: its index is always 0."""
    head = 2 if group is None or group == 1 else 3
    size = (t.shape[0], t.shape[1],
            t.shape[2] * (1 if group is None else group))
    return tuple(t.stride(i) if n > 1 else 0
                 for i, n in zip((0, 1, head), size))


def decode_pass_keys(rows: int, head_dim: int, dtype: torch.dtype) -> int:
    """Keys one ``flash_decode`` block reads in one pass: its 4 warps'
    groups of lanes (a key row in 16-byte pieces, at most 32 lanes) times
    the keys each group has in flight (8 up to 2 rows, 4 at 4, 2 at 8,
    halved where a lane holds 8 words of a row), as the kernel's template
    constants give them."""
    pad = 64 if head_dim <= 64 else (128 if head_dim <= 128 else 256)
    size = torch.empty((), dtype=dtype).element_size()
    lanes = min(32, pad * size // 16)
    words = pad * size // (4 * lanes)  # 32-bit words a lane holds of a row
    in_flight = (8 if rows <= 2 else (4 if rows == 4 else 2)) * 4 // words
    return 4 * (32 // lanes) * in_flight


def _aligned(t: torch.Tensor, strides) -> bool:
    """16-byte aligned base and strides of whole 16-byte chunks (8 bf16, 4
    float32)."""
    return t.data_ptr() % 16 == 0 and all(
        st % (16 // t.element_size()) == 0 for st in strides)


def _inner_dense(name: str, t: torch.Tensor) -> torch.Tensor:
    """``t``, checked to have a last-axis stride of 1."""
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: last axis must be dense, strides "
                         f"{t.stride()}")
    return t


def launch_kernel(kernel: str, q, k, v, *, q_positions, kv_positions,
                  causal: bool = True, window: Optional[int] = None,
                  cap: Optional[float] = None, kv_mask=None) -> torch.Tensor:
    """Run one named kernel of ``KERNELS`` on CUDA tensors, with ``plan``'s
    rows and splits: the kernel ``plan`` picks, or ``flash_fwd`` on any
    prefill call (it takes every head dim and both types); raises
    otherwise. For holding the kernels against the plain version and
    against each other; the model path goes through
    ``flash_attention_gqa``, which follows ``plan``. No autograd."""
    if kernel not in KERNELS:
        raise ValueError(f"flash_attention: no kernel {kernel!r}; one of "
                         f"{KERNELS}")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: {kernel} runs on a CUDA "
                         f"tensor, got '{q.device.type}'")
    return _launch(q, k, v, q_positions, kv_positions, kv_mask, causal,
                   window, cap, kernel)


def _launch(q, k, v, qp, kp, mask, causal, window, cap,
            kernel: Optional[str] = None) -> torch.Tensor:
    B, Sq, KV, G, hd = q.shape
    Sk = k.shape[1]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {hd} > {MAX_HEAD_DIM}")
    out = torch.empty((B, Sq, KV, G, hd), dtype=q.dtype, device=q.device)
    if Sq == 0:
        return out
    if Sk == 0:
        return out.zero_()
    # (KV, G) read as one head axis h = kv * G + g
    if G > 1 and q.stride(2) != G * q.stride(3):
        q = q.contiguous()
    q, k, v = (_inner_dense(n, t) for n, t in (("q", q), ("k", k), ("v", v)))
    qp = qp.to(torch.int32)
    kp = kp.to(torch.int32)
    qp = qp if Sq == 1 or qp.stride(1) == 1 else qp.contiguous()
    kp = kp if Sk == 1 or kp.stride(1) == 1 else kp.contiguous()
    if mask is not None:
        mask = mask.to(torch.bool)
        mask = mask if Sk == 1 or mask.stride(1) == 1 else mask.contiguous()
    chosen, bm, nsplit = plan(B, Sq, Sk, KV, G, q.dtype, hd)
    if kernel is None:
        kernel = chosen
    elif kernel != chosen and (kernel != "flash_fwd"
                               or chosen == "flash_decode"):
        raise ValueError(f"{kernel} does not take this call ({chosen} "
                         f"does): q {tuple(q.shape)} {q.dtype}, Sk {Sk}")
    tensor_cores = kernel in ("flash_fwd_tc", "flash_fwd_tf32")
    if tensor_cores:
        q, k, v = (t if _aligned(t, _strides(t, G if t is q else None))
                   else t.contiguous() for t in (q, k, v))
    part_acc = part_ml = kpm = tsum = None
    if tensor_cores:  # the pre-pass's key positions, summaries
        ktiles = -(-Sk // _KEY_TILE)
        kpm = torch.empty(B * ktiles * _KEY_TILE, dtype=torch.int32,
                          device=q.device)
        tsum = torch.empty(B * ktiles * 4, dtype=torch.int32, device=q.device)
    if nsplit > 1:
        n_rows = B * KV * -(-(Sq * G) // bm) * nsplit * bm
        part_acc = torch.empty(n_rows * hd, dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty(2 * n_rows, dtype=torch.float32,
                              device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        counts = None
        if kernel == "flash_decode" and nsplit > 1:
            # zero counts for the last-split merge, kernels._scratch's
            _, counts = last_block_scratch(
                q.device.index, stream, B * KV * -(-(Sq * G) // bm), 0)
        err = _lib().repro_flash_attention(
            KERNELS.index(kernel), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], qp.data_ptr(), kp.data_ptr(),
            None if mask is None else mask.data_ptr(),
            *_strides(q, G), *_strides(k), *_strides(v), *_strides(out, G),
            qp.stride(0) if B > 1 else 0, kp.stride(0) if B > 1 else 0,
            (mask.stride(0) if B > 1 else 0) if mask is not None else 0,
            B, Sq, Sk, KV, G, hd, int(causal),
            0 if window is None else int(window),
            0.0 if cap is None else float(cap), 1.0 / math.sqrt(hd), bm,
            nsplit, None if part_acc is None else part_acc.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(),
            None if kpm is None else kpm.data_ptr(),
            None if tsum is None else tsum.data_ptr(),
            counts, stream)
    if err != 0:
        msg = _lib().repro_flash_cuda_error_string(err).decode()
        raise KernelError(f"{kernel} launch failed: CUDA error {err} "
                          f"({msg}) for q {tuple(q.shape)} {q.dtype}, k "
                          f"{tuple(k.shape)}")
    LAUNCHES[kernel] += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """Forward through the kernel (the plain version on a CPU tensor);
    backward by recomputing the plain version, as ``_flash_bwd`` does. In
    ``torch.func``'s form (``setup_context``), so that ``torch.func.grad``
    runs through it, and its backward is a ``torch.func.vjp`` of the plain
    version, which nests under an outer transform."""

    @staticmethod
    def forward(q, k, v, qp, kp, mask, causal, window, cap):
        if q.device.type == "cpu":
            return attention_ref(q, k, v, q_positions=qp, kv_positions=kp,
                                 causal=causal, window=window, cap=cap,
                                 kv_mask=mask)
        if q.device.type != "cuda":
            raise ValueError(f"no flash_attention kernel for device "
                             f"'{q.device.type}'")
        return _launch(q, k, v, qp, kp, mask, causal, window, cap)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, qp, kp, mask, causal, window, cap = inputs
        ctx.save_for_backward(q, k, v, qp, kp, mask)
        ctx.opts = (causal, window, cap)

    @staticmethod
    def backward(ctx, g):
        q, k, v, qp, kp, mask = ctx.saved_tensors
        causal, window, cap = ctx.opts

        def plain(q, k, v):
            return attention_ref(q, k, v, q_positions=qp, kv_positions=kp,
                                 causal=causal, window=window, cap=cap,
                                 kv_mask=mask)

        _, vjp = torch.func.vjp(plain, q, k, v)
        grads = vjp(g)
        return (*(d if need else None for d, need in
                  zip(grads, ctx.needs_input_grad[:3])),
                None, None, None, None, None, None)


def flash_attention_gqa(q, k, v, *, q_positions, kv_positions,
                        causal: bool = True, window: Optional[int] = None,
                        cap: Optional[float] = None, kv_mask=None,
                        block_q: int = 128, block_k: int = 128,
                        interpret: Optional[bool] = None):
    """q: (B,Sq,KV,G,hd); k, v: (B,Sk,KV,hd) -> (B,Sq,KV,G,hd).

    ``q_positions`` (B,Sq) and ``kv_positions`` (B,Sk) are absolute token
    positions (any order: a ring-buffer cache permutes them; a batch
    stride of 0 is read as it is). ``kv_mask`` (B,Sk) marks valid cache
    slots; keys past Sk and rows past Sq are masked by the kernel itself.
    q, k and v are float32 or bfloat16, all of one type; the math is
    float32 and the output has q's type. ``block_q`` and ``block_k`` are
    accepted and ignored (``plan`` picks the tiles); ``interpret=True``
    runs the plain version (``kernels._dispatch``).
    """
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if plain_requested(interpret=interpret):
        return attention_ref(q, k, v, q_positions=q_positions,
                             kv_positions=kv_positions, causal=causal,
                             window=window, cap=cap, kv_mask=kv_mask)
    return _FlashAttention.apply(q, k, v, q_positions, kv_positions, kv_mask,
                                 causal, window, cap)
