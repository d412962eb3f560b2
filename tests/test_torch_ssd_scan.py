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
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jref
from repro.nn.ssm import ssd_chunked_ref as jchunked
from repro_torch.kernels.ssd_scan import ops
from repro_torch.nn.ssm import ssd_chunked_ref

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
    want = jax.grad(lambda *a: jnp.sum(jref(*a, chunk=32) * jnp.asarray(w)),
                    argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, ins))
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
