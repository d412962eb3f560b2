"""PyTorch port: ``kernels.ssd_scan`` and ``nn.ssm.ssd_chunked_ref`` held
against the JAX package.

On the CPU the port's wrapper runs its plain version through the same
``torch.autograd.Function`` the card uses; the CUDA kernel itself is held
to that plain version by ``tests/test_torch_kernels_cuda.py`` and
``chip_smoke.py`` on the card. Inputs are made with NumPy. The float32
cases of ``tests/test_kernels.py`` go against the JAX package's
``ssd_scan_ref``, the smallest also against its Pallas kernel in
interpret mode; tolerance 2e-4 of max|ref| (``test_kernels.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_scan as jssd
from repro.kernels.ssd_scan.ref import ssd_scan_ref
from repro.nn.ssm import ssd_chunked_ref as jchunked_eager
from repro_torch.kernels.ssd_scan import ops
from repro_torch.nn.ssm import ssd_chunked_ref
from _jax_reference import _reference_compiled_unoptimised  # noqa: F401


# the JAX package's plain versions, compiled once per shape: the same
# arithmetic as op-by-op dispatch in a tenth of the time
jref = jax.jit(ssd_scan_ref, static_argnames="chunk")
jchunked = jax.jit(jchunked_eager,
                   static_argnames=("chunk", "return_final"))

SSD_CASES = [
    # b, s, h, p, g, n, chunk (test_kernels.py's float32 cases)
    (2, 256, 4, 64, 1, 128, 128),
    (1, 200, 8, 64, 2, 128, 64),
    (2, 64, 2, 32, 1, 16, 32),
]
INTERPRET = {2}


def _rel_err(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-6))


def _inputs(b, s, h, p, g, n, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = (-np.exp(0.5 * rng.standard_normal(h))).astype(np.float32)
    B = rng.standard_normal((b, s, g, n)).astype(np.float32)
    C = rng.standard_normal((b, s, g, n)).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("case", range(len(SSD_CASES)))
def test_ssd_scan_matches_reference(case):
    b, s, h, p, g, n, chunk = SSD_CASES[case]
    ins = _inputs(b, s, h, p, g, n)
    got = ops.ssd_scan(*map(torch.as_tensor, ins), chunk=chunk).numpy()
    assert got.shape == (b, s, h, p) and got.dtype == np.float32
    assert _rel_err(got, jref(*map(jnp.asarray, ins), chunk=chunk)) < 2e-4
    if case in INTERPRET:
        pallas = jssd(*map(jnp.asarray, ins), chunk=chunk, interpret=True)
        assert _rel_err(got, pallas) < 2e-4


def test_ssd_scan_chunk_invariance():
    """chunk 32 against chunk 64 (test_kernels.py's state continuity)."""
    ins = tuple(map(torch.as_tensor, _inputs(1, 128, 2, 32, 1, 64, seed=3)))
    y32 = ops.ssd_scan(*ins, chunk=32).numpy()
    y64 = ops.ssd_scan(*ins, chunk=64).numpy()
    assert _rel_err(y32, y64) < 1e-4


def test_ssd_scan_grad_matches_reference():
    """The autograd.Function's backward (recompute through the plain
    version) against jax.grad of the JAX package's plain version."""
    ins = _inputs(1, 40, 2, 32, 1, 16, seed=5)
    w = np.random.default_rng(6).standard_normal((1, 40, 2, 32)).astype(
        np.float32)
    want = jax.jit(jax.grad(
        lambda *a: jnp.sum(ssd_scan_ref(*a, chunk=32) * jnp.asarray(w)),
        argnums=(0, 1, 2, 3, 4)))(*map(jnp.asarray, ins))
    ts = [torch.tensor(a, requires_grad=True) for a in ins]
    (ops.ssd_scan(*ts, chunk=32) * torch.as_tensor(w)).sum().backward()
    for t, ref in zip(ts, want):
        assert _rel_err(t.grad.numpy(), ref) < 2e-4


def test_chunked_scan_state_matches_reference():
    """The prefill path: initial state in, final state out."""
    x, dt, A, B, C = _inputs(2, 70, 4, 32, 2, 16, seed=8)
    s0 = np.random.default_rng(9).standard_normal((2, 4, 16, 32)).astype(
        np.float32)
    wy, ws = jchunked(*map(jnp.asarray, (x, dt, A, B, C)), chunk=32,
                      initial_state=jnp.asarray(s0), return_final=True)
    gy, gs = ssd_chunked_ref(*map(torch.as_tensor, (x, dt, A, B, C)),
                             chunk=32, initial_state=torch.as_tensor(s0),
                             return_final=True)
    assert _rel_err(gy.numpy(), wy) < 2e-4
    assert _rel_err(gs.numpy(), ws) < 2e-4


def test_interpret_runs_the_plain_version(monkeypatch):
    ins = _inputs(1, 64, 2, 32, 1, 16, seed=4)
    want = jref(*map(jnp.asarray, ins), chunk=32)
    monkeypatch.setattr(ops._SSDScan, "apply",
                        lambda *a: pytest.fail("the kernel route was taken"))
    got = ops.ssd_scan(*map(torch.as_tensor, ins), chunk=32, interpret=True)
    assert _rel_err(got.numpy(), want) < 2e-4
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0)


@pytest.mark.parametrize("call,want", [
    # (h, g, p, n, chunk, dtype, aligned) -> kernel
    ((64, 1, 64, 128, 128, torch.bfloat16, True), "ssd_scan_tc"),  # mamba2
    ((64, 1, 64, 128, 128, torch.float32, True), "ssd_scan"),
    ((64, 1, 64, 128, 32, torch.bfloat16, True), "ssd_scan"),
    ((8, 1, 32, 64, 64, torch.bfloat16, True), "ssd_scan"),
    ((64, 1, 64, 128, 128, torch.bfloat16, False), "ssd_scan"),
    ((8, 2, 64, 128, 64, torch.bfloat16, True), "ssd_scan_tc"),
    ((4, 4, 64, 128, 128, torch.bfloat16, True), "ssd_scan"),
    ((4, 2, 128, 64, 128, torch.bfloat16, True), "ssd_scan_tc"),
    ((4, 1, 64, 32, 128, torch.bfloat16, True), "ssd_scan"),
], ids=["mamba2", "float32", "chunk32", "p32", "unaligned", "g2",
        "one_head_a_group", "p128", "n32"])
def test_plan_picks_the_kernel(call, want):
    assert ops.plan(*call) == want
    assert want in ops.KERNELS


def test_tc_aligned_takes_the_mixers_views():
    """The mixer's x, B and C are views of the convolution output (row
    stride d_inner + 2 g n): 16-byte aligned at mamba2's widths, not when a
    view starts one element in or the row stride is not whole chunks."""
    b, s, h, p, g, n = 2, 8, 4, 64, 1, 128
    conv = torch.zeros(b, s, h * p + 2 * g * n, dtype=torch.bfloat16)
    xs, Bc, Cc = torch.split(conv, [h * p, g * n, g * n], dim=-1)
    views = (xs.reshape(b, s, h, p), Bc.reshape(b, s, g, n),
             Cc.reshape(b, s, g, n))
    assert conv.data_ptr() % 16 == 0
    assert ops.tc_aligned(*views)
    odd = torch.zeros(b * s * (h * p + 2 * g * n) + 1, dtype=torch.bfloat16)
    shifted = odd[1:].view(b, s, -1)[..., :h * p].reshape(b, s, h, p)
    assert not ops.tc_aligned(shifted)
    ragged = torch.zeros(b, s, h * p + 4, dtype=torch.bfloat16)
    assert not ops.tc_aligned(ragged[..., :h * p].reshape(b, s, h, p))


def test_shared_memory_of_both_kernels_fits_a_block():
    """Every (chunk, n, p) that plan sends to each kernel fits the 227 KB a
    block may use; mamba2's call: 231,424 B for ssd_scan_tc (two stages of
    C, B and x, S in bf16, cum and dt) and 215,684 B for the FP32 kernel."""
    for chunk in ops.TC_CHUNKS:
        for n in ops.TC_STATE_DIMS:
            for p in ops.TC_HEAD_DIMS:
                assert ops.smem_bytes(chunk, n, p, "ssd_scan_tc") \
                    <= ops.MAX_SMEM_BYTES
    assert ops.smem_bytes(128, 128, 64, "ssd_scan_tc") == 231_424
    assert ops.smem_bytes(128, 128, 64) == 215_684
    for chunk in ops.CHUNKS:
        for p in ops.HEAD_DIMS:
            assert ops.smem_bytes(chunk, 64, p) <= ops.MAX_SMEM_BYTES


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def _ssd_tc_emulation(x, dt, A, B, C, chunk):
    """``ssd_scan_tc``'s rounding in plain float32 torch: bf16 inputs;
    G = C B^T exact; W = G o exp(cum_i - cum_j) o dt_j rounded to bf16;
    y = e^{cum} (C bf16(S)) + W x, rounded to bf16; S <- e^{cum_L} S +
    bf16(B o segdt)^T x with S kept in float32."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    x, B, C = _bf16(x), _bf16(B), _bf16(C)
    y = torch.zeros(b, s, h, p)
    S = torch.zeros(b, h, n, p)
    for c0 in range(0, s, chunk):
        sl = slice(c0, min(c0 + chunk, s))
        xc, dtc = x[:, sl], dt[:, sl]
        Bc = B[:, sl].repeat_interleave(h // g, dim=2)
        Cc = C[:, sl].repeat_interleave(h // g, dim=2)
        cum = torch.cumsum(dtc * A, dim=1)                      # (b,l,h)
        G = torch.einsum("bihn,bjhn->bhij", Cc, Bc)
        diff = (cum[:, :, None, :] - cum[:, None, :, :]).permute(0, 3, 1, 2)
        causal = torch.ones(xc.shape[1], xc.shape[1]).tril().bool()
        W = torch.where(causal, G * torch.exp(torch.where(causal, diff, 0.0))
                        * dtc.permute(0, 2, 1)[:, :, None, :], 0.0)
        y_inter = torch.exp(cum)[..., None] * torch.einsum(
            "bihn,bhnp->bihp", Cc, _bf16(S))
        y[:, sl] = y_inter + torch.einsum("bhij,bjhp->bihp", _bf16(W), xc)
        cl = cum[:, -1]
        segdt = torch.exp(cl[:, None] - cum) * dtc
        S = torch.exp(cl)[..., None, None] * S + torch.einsum(
            "bjhn,bjhp->bhnp", _bf16(Bc * segdt[..., None]), xc)
    return _bf16(y)


def test_ssd_tc_rounding_matches_jax_pallas():
    """The tensor-core kernel's bf16 rounding of W, S and B o segdt,
    emulated in plain torch, against the JAX package's Pallas kernel in
    interpret mode (float32 on the same bf16-rounded inputs) on a 2-group
    case whose length is no chunk multiple: rel 5e-2, the chip gate's
    bf16 tolerance."""
    ins = _inputs(1, 200, 4, 64, 2, 64, seed=11)
    ins = tuple(_bf16(torch.as_tensor(a)).numpy() if i in (0, 3, 4)
                else a for i, a in enumerate(ins))
    want = jssd(*map(jnp.asarray, ins), chunk=64, interpret=True)
    got = _ssd_tc_emulation(*map(torch.as_tensor, ins), chunk=64)
    assert _rel_err(got.numpy(), want) < 5e-2
    # the float32 plain version of the port, for scale, is far closer
    plain = ops.ssd_scan(*map(torch.as_tensor, ins), chunk=64).numpy()
    assert _rel_err(plain, want) < 2e-4


def test_kernels_package_exports_the_references_kernel_names():
    """``repro_torch.kernels`` exports ``flash_attention_gqa`` and
    ``ssd_scan`` as ``repro.kernels`` does: the subpackages' functions,
    with ``repro_torch.kernels.ssd_scan.ops`` still importable."""
    import importlib

    import repro.kernels as jkernels
    import repro_torch.kernels as tkernels
    from repro_torch.kernels import flash_attention_gqa, ssd_scan
    from repro_torch.kernels.flash_attention import ops as flash_ops
    assert flash_attention_gqa is flash_ops.flash_attention_gqa
    assert ssd_scan is ops.ssd_scan
    assert importlib.import_module("repro_torch.kernels.ssd_scan.ops") is ops
    for name in ("flash_attention_gqa", "ssd_scan"):
        assert name in tkernels.__all__
        assert callable(getattr(jkernels, name))
