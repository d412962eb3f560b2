"""Public wrapper of the flash-attention kernel.

``flash_attention_gqa`` takes the JAX package's layout, q (B,Sq,KV,G,hd)
and k, v (B,Sk,KV,hd), with absolute positions for both and an optional
kv validity mask. On a CUDA tensor it launches the hand-written kernel in
``csrc/flash_attention.cu`` (or raises); on a CPU tensor it runs the plain
version in ``ref.py``. Nothing falls back. Launches are counted in
``LAUNCHES``.

The kernel reads q, k and v through their strides (the last axis must be
dense) and masks ragged lengths itself, so the wrapper pads and copies
nothing. A call with few blocks (decode) splits its keys (``plan``): the
wrapper then allocates the partials' scratch and the source's combine
kernel merges them, a second launch within the same call. The
``torch.autograd.Function``'s backward recomputes attention through the
plain version, as the JAX package's ``_flash_bwd`` does (no attention
matrix is kept from the forward).
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels._build import KernelError, load_library
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["LAUNCHES", "reset_launch_counts", "flash_attention_gqa",
           "kernel_source", "plan", "MAX_HEAD_DIM"]

# launches since the last reset (one per call that reached the card)
LAUNCHES = {"flash_attention": 0}
MAX_HEAD_DIM = 256
_SMS = 132        # streaming multiprocessors of an H100 SXM
_KEY_TILE = 64    # keys per tile (kBK in the source)
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
            [p] * 4 + [i32] + [p] * 3 + [i64] * 15 + [i32] * 8 + [f32, f32]
            + [i32, i32, p, p, p])
        lib.repro_flash_attention.restype = i32
        lib.repro_flash_cuda_error_string.argtypes = [i32]
        lib.repro_flash_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def plan(batch: int, sq: int, sk: int, kv_heads: int, group: int):
    """(rows per block, key splits per row tile) for one call: 16 rows when
    there are fewer than 64 (decode), else 64; when the (batch, kv head,
    row tile) blocks are fewer than the card's 132 SMs, the key tiles are
    split so that about 4 blocks per SM run, at most one split per tile.
    A function of the shapes alone, so reruns take the same path."""
    rows = sq * group
    bm = 16 if rows < 64 else 64
    blocks = -(-rows // bm) * kv_heads * batch
    if blocks >= _SMS:
        return bm, 1
    return bm, max(1, min(-(-sk // _KEY_TILE), -(-4 * _SMS // blocks)))


def _inner_dense(name: str, t: torch.Tensor) -> torch.Tensor:
    """``t``, checked to have a last-axis stride of 1."""
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: last axis must be dense, strides "
                         f"{t.stride()}")
    return t


def _launch(q, k, v, qp, kp, mask, causal, window, cap) -> torch.Tensor:
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
    bm, nsplit = plan(B, Sq, Sk, KV, G)
    part_acc = part_ml = None
    if nsplit > 1:
        n_rows = B * KV * -(-(Sq * G) // bm) * nsplit * bm
        part_acc = torch.empty(n_rows * hd, dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty(2 * n_rows, dtype=torch.float32,
                              device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], qp.data_ptr(), kp.data_ptr(),
            None if mask is None else mask.data_ptr(),
            q.stride(0), q.stride(1), q.stride(3),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(3),
            qp.stride(0) if B > 1 else 0, kp.stride(0) if B > 1 else 0,
            (mask.stride(0) if B > 1 else 0) if mask is not None else 0,
            B, Sq, Sk, KV, G, hd, int(causal),
            0 if window is None else int(window),
            0.0 if cap is None else float(cap), 1.0 / math.sqrt(hd), bm,
            nsplit, None if part_acc is None else part_acc.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(), stream)
    if err != 0:
        msg = _lib().repro_flash_cuda_error_string(err).decode()
        raise KernelError(f"flash_attention launch failed: CUDA error {err} "
                          f"({msg}) for q {tuple(q.shape)}, k "
                          f"{tuple(k.shape)}")
    LAUNCHES["flash_attention"] += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """Forward through the kernel (the plain version on a CPU tensor);
    backward by recomputing the plain version, as ``_flash_bwd`` does."""

    @staticmethod
    def forward(ctx, q, k, v, qp, kp, mask, causal, window, cap):
        ctx.save_for_backward(q, k, v, qp, kp, mask)
        ctx.opts = (causal, window, cap)
        if q.device.type == "cpu":
            return attention_ref(q, k, v, q_positions=qp, kv_positions=kp,
                                 causal=causal, window=window, cap=cap,
                                 kv_mask=mask)
        if q.device.type != "cuda":
            raise ValueError(f"no flash_attention kernel for device "
                             f"'{q.device.type}'")
        return _launch(q, k, v, qp, kp, mask, causal, window, cap)

    @staticmethod
    def backward(ctx, g):
        q, k, v, qp, kp, mask = ctx.saved_tensors
        causal, window, cap = ctx.opts
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need) for t, need in
                   zip((q, k, v), ctx.needs_input_grad[:3])]
            out = attention_ref(*ins, q_positions=qp, kv_positions=kp,
                                causal=causal, window=window, cap=cap,
                                kv_mask=mask)
            wrt = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, g) if wrt else ())
        dq, dk, dv = (next(grads) if t.requires_grad else None for t in ins)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_gqa(q, k, v, *, q_positions, kv_positions,
                        causal: bool = True, window: Optional[int] = None,
                        cap: Optional[float] = None, kv_mask=None):
    """q: (B,Sq,KV,G,hd); k, v: (B,Sk,KV,hd) -> (B,Sq,KV,G,hd).

    ``q_positions`` (B,Sq) and ``kv_positions`` (B,Sk) are absolute token
    positions (any order: a ring-buffer cache permutes them; a batch
    stride of 0 is read as it is). ``kv_mask`` (B,Sk) marks valid cache
    slots; keys past Sk and rows past Sq are masked by the kernel itself.
    q, k and v are float32 or bfloat16, all of one type; the math is
    float32 and the output has q's type.
    """
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    return _FlashAttention.apply(q, k, v, q_positions, kv_positions, kv_mask,
                                 causal, window, cap)
