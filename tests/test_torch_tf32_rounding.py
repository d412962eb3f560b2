"""PyTorch port: the 3xTF32 products of ``flash_fwd_tf32`` and
``ssd_scan_tf32``, emulated in plain float32 torch on the CPU.

The kernels run only on the card (``tests/test_torch_kernels_cuda.py`` and
``chip_smoke.py`` hold them to their plain versions there). This file
guards their precision choice where there is no card: each operand a of a
product is split into hi (a rounded to 10 mantissa bits, ties away from
zero: the kernels' ``split_tf32``) and lo = a - hi, which the tensor cores
read to 10 bits (the low 13 bits of a TF32 operand are ignored), and the
product is lo*hi + hi*lo + hi*hi in float32. On a small flash case and a
small SSD case that stays within the float32 gates' tolerances of the
plain versions (2e-5 and 2e-4 of max|plain|); one TF32 pass does not.
No JAX: inputs come from NumPy.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

FLASH_TOL, SSD_TOL = 2e-5, 2e-4


def _t(a):
    return torch.as_tensor(a, dtype=torch.float32)


def _rel_err(a, b):
    return float((a - b).abs().max() / (b.abs().max() + 1e-6))


def _tf32_read(a):
    """``a`` as the tensor cores read a TF32 operand: the low 13 bits of
    its float32 pattern ignored."""
    return (a.contiguous().view(torch.int32) & -8192).view(torch.float32)


def _split(a):
    """(hi, lo): hi rounded to TF32 (half a unit of the 13 dropped bits
    added to the magnitude, then the bits cleared), lo = a - hi as read."""
    hi = ((a.contiguous().view(torch.int32) + 0x1000) & -8192).view(
        torch.float32)
    return hi, _tf32_read(a - hi)


def _mm(a, b, passes):
    """a @ b in 3xTF32 (lo*hi + hi*lo + hi*hi) or, ``passes=1``, one TF32
    pass of the rounded operands."""
    ah, al = _split(a)
    bh, bl = _split(b)
    if passes == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def test_split_is_exact_and_rounds_ties_away_from_zero():
    a = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 3 * 2.0 ** -12, math.pi, -1e-30, 0.0])
    hi, lo = _split(a)
    assert torch.equal(_tf32_read(hi), hi)
    # half an ulp of TF32 goes away from zero, in either sign
    assert hi[0] == 1.0 + 2.0 ** -10 and hi[1] == -(1.0 + 2.0 ** -10)
    assert hi[2] == 1.0 + 2.0 ** -10
    # hi + lo before lo is read to 10 bits is a
    full_lo = a - hi
    assert torch.equal(hi + full_lo, a)
    assert (lo - full_lo).abs().max() <= a.abs().max() * 2.0 ** -21


def _flash_emulated(q, k, v, *, q_positions, kv_positions, causal, window,
                    cap, kv_mask, passes):
    """attention_ref's math with Q K^T and P V in TF32 products, P as the
    kernel forms it (exp of the scores less the row's max)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qh = q.permute(0, 2, 3, 1, 4)                   # (B,KV,G,Sq,hd)
    kh = k.permute(0, 2, 1, 3)[:, :, None]          # (B,KV,1,Sk,hd)
    vh = v.permute(0, 2, 1, 3)[:, :, None]
    scores = _mm(qh, kh.transpose(-1, -2), passes) * scale
    if cap is not None:
        scores = cap * torch.tanh(scores / cap)
    dq = q_positions[:, :, None]
    dk = kv_positions[:, None, :]
    mask = kv_mask[:, None, :] & (dk <= dq if causal else True)
    if window is not None:
        mask = mask & (dq - dk < window)
    mask = mask[:, None, None]
    scores = torch.where(mask, scores, -1e30)
    m = scores.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    l = p.sum(-1, keepdim=True)
    out = _mm(p, vh, passes) / torch.where(l == 0, 1.0, l)
    return out.permute(0, 3, 1, 2, 4)


@pytest.mark.parametrize("hd,window,cap", [(64, None, None), (128, 24, 50.0)],
                         ids=["smollm_like", "gemma2_like"])
def test_flash_tf32_products_hold_the_float32_gate(hd, window, cap):
    rng = np.random.default_rng(21)
    B, Sq, Sk, KV, G = 2, 70, 96, 2, 3
    q = _t(rng.standard_normal((B, Sq, KV, G, hd)))
    k = _t(rng.standard_normal((B, Sk, KV, hd)))
    v = _t(rng.standard_normal((B, Sk, KV, hd)))
    kp = torch.arange(Sk, dtype=torch.int32)
    kw = dict(q_positions=kp[Sk - Sq:][None].expand(B, Sq),
              kv_positions=kp[None].expand(B, Sk),
              kv_mask=((kp % 13) != 5)[None].expand(B, Sk), causal=True,
              window=window, cap=cap)
    want = attention_ref(q, k, v, **kw)
    got = _flash_emulated(q, k, v, passes=3, **kw)
    assert _rel_err(got, want) < FLASH_TOL
    assert _rel_err(_flash_emulated(q, k, v, passes=1, **kw), want) \
        > FLASH_TOL


def _ssd_emulated(x, dt, A, B, C, passes, sub=64):
    """``ssd_scan_tf32``'s walk in plain torch: sub-chunks of 64 positions,
    G = C B^T, W = G o exp(cum_i - cum_j) o dt_j, y = e^{cum} (C S) + W x,
    S <- e^{cum_L} S + (B o segdt)^T x, every product in TF32 passes, S in
    float32."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    Bh = B.repeat_interleave(h // g, dim=2)
    Ch = C.repeat_interleave(h // g, dim=2)
    y = torch.zeros(b, s, h, p)
    S = torch.zeros(b, h, n, p)
    for c0 in range(0, s, sub):
        sl = slice(c0, min(c0 + sub, s))
        xc = x[:, sl].permute(0, 2, 1, 3)               # (b,h,l,p)
        Bc = Bh[:, sl].permute(0, 2, 1, 3)              # (b,h,l,n)
        Cc = Ch[:, sl].permute(0, 2, 1, 3)
        dtc = dt[:, sl].permute(0, 2, 1)                # (b,h,l)
        cum = torch.cumsum(dtc * A[None, :, None], dim=-1)
        L = xc.shape[2]
        causal = torch.ones(L, L).tril().bool()
        diff = cum[..., :, None] - cum[..., None, :]
        W = torch.where(causal, _mm(Cc, Bc.transpose(-1, -2), passes)
                        * torch.exp(torch.where(causal, diff, 0.0))
                        * dtc[..., None, :], 0.0)
        y_inter = torch.exp(cum)[..., None] * _mm(Cc, S, passes)
        y[:, sl] = (y_inter + _mm(W, xc, passes)).permute(0, 2, 1, 3)
        cl = cum[..., -1:]
        segdt = torch.exp(cl - cum) * dtc
        S = torch.exp(cl)[..., None] * S + _mm(
            (Bc * segdt[..., None]).transpose(-1, -2), xc, passes)
    return y


def test_ssd_tf32_products_hold_the_float32_gate():
    rng = np.random.default_rng(22)
    b, s, h, p, g, n = 1, 200, 4, 64, 2, 64
    x = _t(rng.standard_normal((b, s, h, p)))
    dt = _t(np.log1p(np.exp(rng.standard_normal((b, s, h)))))
    A = _t(-np.exp(0.5 * rng.standard_normal(h)))
    B = _t(rng.standard_normal((b, s, g, n)))
    C = _t(rng.standard_normal((b, s, g, n)))
    want = ssd_scan_ref(x, dt, A, B, C, chunk=128)
    assert _rel_err(_ssd_emulated(x, dt, A, B, C, passes=3), want) < SSD_TOL
    assert _rel_err(_ssd_emulated(x, dt, A, B, C, passes=1), want) > SSD_TOL
