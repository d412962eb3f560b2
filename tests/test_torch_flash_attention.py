"""PyTorch port: ``kernels.flash_attention`` held against the JAX package.

On the CPU the port's wrapper runs its plain version (``ref.py``) through
the same ``torch.autograd.Function`` the card uses; the CUDA kernel itself
is held to that plain version by ``tests/test_torch_kernels_cuda.py`` and
``chip_smoke.py`` on the card. Inputs are made with NumPy. The float32
cases of ``tests/test_kernels.py`` go against the JAX package's
``attention_ref``, the smallest ones also against its Pallas kernel in
interpret mode; tolerance 2e-5 of max|ref| (``test_kernels.py``'s
``_rel_err``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import \
    flash_attention_gqa as jflash
from repro.kernels.flash_attention.ref import attention_ref as jref_eager
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.nn.attention import attention_core
from _jax_reference import _reference_compiled_unoptimised  # noqa: F401


# tests/test_kernels.py's FLASH_CASES in float32 (its bf16 cases run on the
# card, where the kernel reads bf16)
FLASH_CASES = [
    # B, Sq, Sk, KV, G, hd, causal, window, cap
    (2, 128, 128, 2, 2, 64, True, None, None),
    (1, 256, 256, 1, 4, 128, True, None, 50.0),
    (2, 100, 100, 2, 1, 64, True, 64, None),
    (1, 64, 64, 4, 1, 128, False, None, None),     # encoder
    (1, 1, 96, 2, 2, 64, True, None, None),        # decode
    (1, 8, 160, 1, 2, 256, True, 32, 30.0),        # all options
]
INTERPRET = {4, 5}  # indices of the cases also run through Pallas
# the JAX package's plain version, compiled once per shape and options:
# the same arithmetic as op-by-op dispatch, several times faster
jref = jax.jit(jref_eager, static_argnames=("causal", "window", "cap"))


def _rel_err(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-6))


def _inputs(B, Sq, Sk, KV, G, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, KV, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    qpos = np.broadcast_to(np.arange(Sk - Sq, Sk, dtype=np.int32), (B, Sq))
    kpos = np.broadcast_to(np.arange(Sk, dtype=np.int32), (B, Sk))
    return q, k, v, np.array(qpos), np.array(kpos)


def _port(q, k, v, qpos, kpos, mask, **kw):
    t = torch.as_tensor
    return ops.flash_attention_gqa(
        t(q), t(k), t(v), q_positions=t(qpos), kv_positions=t(kpos),
        kv_mask=None if mask is None else t(mask), **kw).numpy()


@pytest.mark.parametrize("case", range(len(FLASH_CASES)))
def test_flash_matches_reference(case):
    B, Sq, Sk, KV, G, hd, causal, window, cap = FLASH_CASES[case]
    q, k, v, qpos, kpos = _inputs(B, Sq, Sk, KV, G, hd)
    mask = kpos < (Sk - 3)  # a partly filled cache
    kw = dict(causal=causal, window=window, cap=cap)
    got = _port(q, k, v, qpos, kpos, mask, **kw)
    assert got.shape == (B, Sq, KV, G, hd) and got.dtype == np.float32
    want = jref(*map(jnp.asarray, (q, k, v)), q_positions=jnp.asarray(qpos),
                kv_positions=jnp.asarray(kpos), kv_mask=jnp.asarray(mask),
                **kw)
    assert _rel_err(got, want) < 2e-5
    if case in INTERPRET:
        pallas = jflash(*map(jnp.asarray, (q, k, v)),
                        q_positions=jnp.asarray(qpos),
                        kv_positions=jnp.asarray(kpos),
                        kv_mask=jnp.asarray(mask), interpret=True, **kw)
        assert _rel_err(got, pallas) < 2e-5


def test_flash_ring_buffer_positions():
    """Permuted kv positions (the ring-buffer decode layout), against the
    Pallas kernel in interpret mode."""
    B, Sk, KV, G, hd = 2, 64, 2, 2, 64
    q, k, v, _, _ = _inputs(B, 1, Sk, KV, G, hd, seed=7)
    last = 100
    slot = np.arange(Sk, dtype=np.int32)
    kpos = np.array(np.broadcast_to(last - ((last - slot) % Sk), (B, Sk)))
    qpos = np.full((B, 1), last, np.int32)
    got = _port(q, k, v, qpos, kpos, None, causal=True, window=48, cap=None)
    want = jflash(*map(jnp.asarray, (q, k, v)), q_positions=jnp.asarray(qpos),
                  kv_positions=jnp.asarray(kpos), causal=True, window=48,
                  cap=None, interpret=True)
    assert _rel_err(got, want) < 2e-5


def test_flash_grad_matches_reference():
    """The autograd.Function's backward (recompute through the plain
    version) against jax.grad of the JAX package's custom_vjp."""
    B, S, KV, G, hd = 1, 32, 1, 2, 64
    q, k, v, pos, _ = _inputs(B, S, S, KV, G, hd, seed=1)
    w = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)

    def jloss(q_, k_, v_):
        o = jref(q_, k_, v_, q_positions=jnp.asarray(pos),
                 kv_positions=jnp.asarray(pos), causal=True, window=20,
                 cap=30.0)
        return jnp.sum(o * jnp.asarray(w))

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o = ops.flash_attention_gqa(tq, tk, tv, q_positions=torch.as_tensor(pos),
                                kv_positions=torch.as_tensor(pos),
                                causal=True, window=20, cap=30.0)
    (o * torch.as_tensor(w)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        assert _rel_err(got.numpy(), ref) < 2e-5


def test_flash_masked_rows_are_zero_and_holes_are_skipped():
    B, Sq, Sk, KV, G, hd = 2, 6, 40, 1, 3, 16
    q, k, v, qpos, kpos = _inputs(B, Sq, Sk, KV, G, hd, seed=4)
    qpos = qpos.copy()
    qpos[:, 0] = -5              # before every key: a fully masked row
    mask = np.ones((B, Sk), bool)
    mask[:, 10:30:3] = False     # holes in the cache
    got = _port(q, k, v, qpos, kpos, mask, causal=True, window=None,
                cap=None)
    assert np.all(got[:, 0] == 0.0)
    want = attention_ref(*map(torch.as_tensor, (q, k, v)),
                         q_positions=torch.as_tensor(qpos),
                         kv_positions=torch.as_tensor(kpos), causal=True,
                         window=None, cap=None,
                         kv_mask=torch.as_tensor(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    # a hole's key changes nothing
    k2, v2 = k.copy(), v.copy()
    k2[:, 13], v2[:, 13] = 9.0, -9.0
    again = _port(q, k2, v2, qpos, kpos, mask, causal=True, window=None,
                  cap=None)
    np.testing.assert_allclose(again, got, rtol=0, atol=1e-6)


def test_dense_route_equals_flash_route():
    B, Sq, Sk, KV, G, hd = 2, 12, 12, 2, 2, 16
    q, k, v, qpos, kpos = _inputs(B, Sq, Sk, KV, G, hd, seed=5)
    t = torch.as_tensor
    kw = dict(q_positions=t(qpos), kv_positions=t(kpos), causal=True,
              window=5, cap=20.0)
    dense = attention_core(t(q), t(k), t(v), impl="xla", **kw)
    flash = attention_core(t(q), t(k), t(v), impl="flash", **kw)
    assert _rel_err(flash.numpy(), dense.numpy()) < 2e-5


def test_interpret_and_block_sizes_run_the_plain_version():
    B, Sq, Sk, KV, G, hd = 1, 8, 40, 2, 2, 16
    q, k, v, qpos, kpos = _inputs(B, Sq, Sk, KV, G, hd, seed=3)
    kw = dict(causal=True, window=None, cap=None)
    want = jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kpos),
                kv_mask=None, **kw)
    ops.reset_launch_counts()
    for extra in (dict(interpret=True), dict(block_q=16, block_k=32),
                  dict(block_q=8, block_k=8, interpret=None)):
        got = _port(q, k, v, qpos, kpos, None, **kw, **extra)
        assert _rel_err(got, want) < 1e-5
    assert ops.LAUNCHES == dict.fromkeys(ops.KERNELS, 0)


# (B, Sq, Sk, KV, G, dtype, hd) of the LM paths' calls and what plan gives
PLANS = [
    # smollm-360m serving: prefill, then decode
    ((8, 1024, 1088, 5, 3, torch.bfloat16, 64), ("flash_fwd_tc", 64, 1)),
    ((8, 1, 1088, 5, 3, torch.bfloat16, 64), ("flash_decode", 4, 9)),
    # gemma2-27b: the local layer's ring prefill and both decodes
    ((2, 4160, 8256, 16, 2, torch.bfloat16, 128), ("flash_fwd_tc", 64, 1)),
    ((2, 1, 4096, 16, 2, torch.bfloat16, 128), ("flash_decode", 2, 12)),
    ((2, 1, 4192, 16, 2, torch.bfloat16, 128), ("flash_decode", 2, 12)),
    # the float32 gates: FP32 prefill, the decode kernel in float32
    ((8, 1024, 1088, 5, 3, torch.float32, 64), ("flash_fwd", 64, 1)),
    ((8, 1, 1088, 5, 3, torch.float32, 64), ("flash_decode", 4, 9)),
    # other head dims in bf16 go to flash_fwd; a small prefill splits
    ((2, 40, 40, 2, 3, torch.bfloat16, 16), ("flash_fwd", 64, 1)),
    ((1, 256, 256, 1, 4, torch.bfloat16, 128), ("flash_fwd_tc", 64, 4)),
    # G rows in registers: R the power of two >= rows, at most 8
    ((1, 1, 96, 2, 8, torch.bfloat16, 64), ("flash_decode", 8, 2)),
    ((1, 7, 96, 1, 9, torch.bfloat16, 64), ("flash_decode", 8, 2)),
    ((3, 1, 50, 1, 1, torch.float32, 100), ("flash_decode", 1, 1)),
]


@pytest.mark.parametrize("shape,want", PLANS)
def test_plan_picks_the_kernel_from_shapes_alone(shape, want):
    got = ops.plan(*shape[:5], dtype=shape[5], head_dim=shape[6])
    assert tuple(got) == want
    assert got.kernel in ops.KERNELS
    B, Sq, Sk, KV, G = shape[:5]
    rows = Sq * G
    if got.kernel == "flash_decode":
        assert rows < 64 and got.rows >= min(rows, 8)
        # the blocks run in one wave and fill the card at least twice,
        # unless each already reads its keys in two passes
        blocks = -(-rows // got.rows) * KV * B * got.nsplit
        assert blocks <= (3 if got.rows <= 4 else 2) * 132
        two_passes = 2 * ops.decode_pass_keys(got.rows, shape[6], shape[5])
        assert blocks >= 2 * 132 or got.nsplit * two_passes >= Sk
