"""Mamba-2 SSD mixer (state-space duality, chunked algorithm).

The sequence is processed in chunks of length L: quadratic attention-like
work inside a chunk plus a linear recurrence of per-chunk states across
chunks. The chunk core is either the hand-written ``ssd_scan`` kernel
(``impl="pallas"``, the JAX package's name for its kernel route) or the
plain-torch chunked scan (``impl="xla"``).

Decode carries an O(1) recurrent state: the (B, H, N, P) SSM state and the
depthwise-convolution tail. Prefill runs the plain-torch scan, which also
returns the final state for the decode cache; the kernel keeps its state
on chip and does not export it (ROADMAP Queue 1 item 9), as in the JAX
package.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.nn.common import Initializer, rms_norm

__all__ = ["init_mamba2_params", "mamba2_mixer", "mamba2_prefill",
           "mamba2_decode_step", "make_mamba2_cache", "ssd_chunked_ref"]


def init_mamba2_params(init: Initializer, path: str, d_model: int,
                       d_inner: int, d_state: int, head_dim: int,
                       d_conv: int = 4, n_groups: int = 1) -> Dict[str, Any]:
    n_heads = d_inner // head_dim
    conv_dim = d_inner + 2 * n_groups * d_state
    a_log = torch.log(torch.arange(1, n_heads + 1, dtype=torch.float32))
    return {
        "in_proj": init.dense(f"{path}/in_proj",
                              (d_model, 2 * d_inner + 2 * n_groups * d_state
                               + n_heads)),
        "conv_w": init.dense(f"{path}/conv_w", (d_conv, conv_dim),
                             fan_in=d_conv),
        "A_log": init.zeros(f"{path}/A_log", (n_heads,))
        + a_log.to(init.dtype).to(init.device),
        "D": init.ones(f"{path}/D", (n_heads,)),
        "dt_bias": init.zeros(f"{path}/dt_bias", (n_heads,)),
        "norm_scale": init.zeros(f"{path}/norm", (d_inner,)),
        "out_proj": init.dense(f"{path}/out_proj", (d_inner, d_model),
                               fan_in=d_inner),
    }


def _split_in_proj(zxbcdt, d_inner, d_state, n_groups):
    conv_dim = d_inner + 2 * n_groups * d_state
    return torch.split(zxbcdt, [d_inner, conv_dim,
                                zxbcdt.shape[-1] - d_inner - conv_dim], dim=-1)


def ssd_chunked_ref(x, dt, A, B, C, chunk: int, initial_state=None,
                    return_final: bool = False):
    """Plain-torch chunked SSD. x:(b,s,h,p) dt:(b,s,h) A:(h,) B,C:(b,s,g,n).

    Returns y:(b,s,h,p); with ``return_final`` also the outgoing SSM state
    (b,h,n,p), which the prefill path writes into the decode cache.
    ``initial_state`` continues from a previous segment. Unaligned lengths
    are padded with dt=0 (zero decay and update contribution).
    """
    b, s_orig, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    s = -(-s_orig // chunk) * chunk
    if s != s_orig:
        pad = (0, 0, 0, 0, 0, s - s_orig)
        x, B, C = F.pad(x, pad), F.pad(B, pad), F.pad(C, pad)
        dt = F.pad(dt, (0, 0, 0, s - s_orig))
    nc = s // chunk

    xc = x.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bh = B.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3).float()
    Ch = C.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3).float()

    dA = dtc * A.float()[None, None, None, :]                 # (b,nc,l,h) <0
    cum = torch.cumsum(dA, dim=2)                              # (b,nc,l,h)

    # intra-chunk: y_i += sum_{j<=i} C_i.B_j exp(cum_i - cum_j) dt_j x_j;
    # the mask goes INSIDE the exp: anticausal (i<j) differences are
    # positive and can overflow float32 (and 0 * inf is NaN)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (b,nc,i,j,h)
    idx = torch.arange(chunk, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    decay = torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)),
                        0.0)
    cb = torch.einsum("bclhn,bcmhn->bclmh", Ch, Bh)            # (b,nc,i,j,h)
    w = cb * decay * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bclmh,bcmhp->bclhp", w, xc)

    # chunk-final states: S_c = sum_j exp(cum_last - cum_j) dt_j B_j x_j^T
    sdt = torch.exp(cum[:, :, -1:, :] - cum) * dtc
    states = torch.einsum("bclh,bclhn,bclhp->bchnp", sdt, Bh, xc)

    # inter-chunk recurrence: S_c_in = exp(sum dA_c) S_{c-1}_in + S_{c-1}
    chunk_decay = torch.exp(cum[:, :, -1, :])                  # (b,nc,h)
    prev = (torch.zeros_like(states[:, 0]) if initial_state is None
            else initial_state.float())
    incoming = []
    for c in range(nc):
        incoming.append(prev)  # the INCOMING state of chunk c
        prev = prev * chunk_decay[:, c, :, None, None] + states[:, c]
    incoming = torch.stack(incoming, dim=1)                    # (b,nc,h,n,p)

    # inter-chunk contribution: y_i += C_i . (exp(cum_i) * S_in)
    y_inter = torch.einsum("bclhn,bclh,bchnp->bclhp", Ch, torch.exp(cum),
                           incoming)

    y = (y_intra + y_inter).reshape(b, s, h, p)[:, :s_orig].to(x.dtype)
    if return_final:
        return y, prev
    return y


def make_mamba2_cache(batch: int, d_inner: int, d_state: int, head_dim: int,
                      n_groups: int = 1, d_conv: int = 4,
                      dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    n_heads = d_inner // head_dim
    conv_dim = d_inner + 2 * n_groups * d_state
    return {
        "ssm": torch.zeros((batch, n_heads, d_state, head_dim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, d_conv - 1, conv_dim), dtype=dtype,
                            device=device),
    }


def _causal_conv(xbc, conv_w, conv_tail=None):
    """Depthwise causal conv, width K. xbc: (B,S,C); conv_w: (K,C)."""
    K = conv_w.shape[0]
    if conv_tail is None:
        pad = torch.zeros((xbc.shape[0], K - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = conv_tail
    xp = torch.cat([pad, xbc], dim=1)  # (B, S+K-1, C)
    S = xbc.shape[1]
    out = xp[:, 0:S, :] * conv_w[0][None, None, :]
    for i in range(1, K):
        out = out + xp[:, i:i + S, :] * conv_w[i][None, None, :]
    new_tail = xp[:, -(K - 1):, :] if K > 1 else None
    return F.silu(out.float()).to(xbc.dtype), new_tail


def _mixer_inputs(params, x, d_inner, d_state, head_dim, n_groups,
                  conv_tail=None):
    """in_proj, the causal conv and the split: (z, xs, B, C, dt, A, tail)."""
    Bsz, S, _ = x.shape
    n_heads = d_inner // head_dim
    zxbcdt = x @ params["in_proj"]
    z, xbc, dt = _split_in_proj(zxbcdt, d_inner, d_state, n_groups)
    xbc, new_tail = _causal_conv(xbc, params["conv_w"], conv_tail)
    xs, Bc, Cc = torch.split(xbc, [d_inner, n_groups * d_state,
                                   n_groups * d_state], dim=-1)
    xs = xs.reshape(Bsz, S, n_heads, head_dim)
    Bc = Bc.reshape(Bsz, S, n_groups, d_state)
    Cc = Cc.reshape(Bsz, S, n_groups, d_state)
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    return z, xs, Bc, Cc, dt, A, new_tail


def _mixer_output(params, x, y, xs, z, d_inner):
    Bsz, S, _ = x.shape
    y = y + xs * params["D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(Bsz, S, d_inner)
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), params["norm_scale"])
    return y @ params["out_proj"]


def mamba2_mixer(params, x, *, d_inner: int, d_state: int, head_dim: int,
                 n_groups: int = 1, chunk: int = 128,
                 impl: str = "xla") -> torch.Tensor:
    """Training and scoring path. x: (B,S,D) -> (B,S,D)."""
    z, xs, Bc, Cc, dt, A, _ = _mixer_inputs(params, x, d_inner, d_state,
                                            head_dim, n_groups)
    if impl == "pallas":
        from repro_torch.kernels.ssd_scan import ops as ssd_ops
        y = ssd_ops.ssd_scan(xs, dt, A, Bc, Cc, chunk=chunk)
    else:
        y = ssd_chunked_ref(xs, dt, A, Bc, Cc, chunk=chunk)
    return _mixer_output(params, x, y, xs, z, d_inner)


def mamba2_prefill(params, x, cache, *, d_inner: int, d_state: int,
                   head_dim: int, n_groups: int = 1, chunk: int = 128
                   ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Prefill: the full-sequence mixer that also WRITES the decode cache
    (final SSM state and conv tail), through the plain-torch scan."""
    z, xs, Bc, Cc, dt, A, new_tail = _mixer_inputs(
        params, x, d_inner, d_state, head_dim, n_groups, cache["conv"])
    y, final = ssd_chunked_ref(xs, dt, A, Bc, Cc, chunk=chunk,
                               initial_state=cache["ssm"], return_final=True)
    out = _mixer_output(params, x, y, xs, z, d_inner)
    return out, {"ssm": final, "conv": new_tail}


def mamba2_decode_step(params, x, cache, *, d_inner: int, d_state: int,
                       head_dim: int, n_groups: int = 1
                       ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One-token decode. x: (B,1,D); O(1) state update."""
    Bsz, S, _ = x.shape
    assert S == 1
    n_heads = d_inner // head_dim
    z, xs, Bc, Cc, dt, A, new_tail = _mixer_inputs(
        params, x, d_inner, d_state, head_dim, n_groups, cache["conv"])
    xs = xs[:, 0]                                              # (B,H,P)
    rep = n_heads // n_groups
    Bc = Bc[:, 0].repeat_interleave(rep, dim=1)                # (B,H,N)
    Cc = Cc[:, 0].repeat_interleave(rep, dim=1)
    dt = dt[:, 0]                                              # (B,H)
    dA = torch.exp(dt * A[None, :])
    outer = torch.einsum("bh,bhn,bhp->bhnp", dt, Bc.float(), xs.float())
    new_ssm = cache["ssm"] * dA[..., None, None] + outer
    y = torch.einsum("bhn,bhnp->bhp", Cc.float(), new_ssm)
    y = y.to(x.dtype)[:, None]                                 # (B,1,H,P)
    out = _mixer_output(params, x, y, xs[:, None], z, d_inner)
    return out, {"ssm": new_ssm, "conv": new_tail}

