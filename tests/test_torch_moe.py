"""PyTorch port: the Mixture-of-Experts FFN (``repro_torch.nn.moe``) and
multi-head latent attention (``repro_torch.nn.attention``'s MLA) held
against the JAX package on the same NumPy inputs and weights, in float32.

* MLA without a cache, then a prefill with a cache and one decode step,
  outputs and caches at rtol/atol 1e-5.
* ``moe_ffn`` against ``repro.nn.moe.moe_ffn``: x (2, 16, 32), 8 experts,
  top-2, one shared expert (``tests/_torch_dist.py``'s ``moe_case``); the
  value and the gradients of ``sum(y * w)`` (every leaf and x,
  ``jax.grad`` against ``torch.autograd.grad``) at 1e-5, at the default
  capacity (where pairs are dropped, asserted) and at capacity E / k.
  Every token's gap between its k-th and (k+1)-th gate exceeds 1e-4
  (asserted), so no near-tie can route a pair differently in the two
  packages.
* ``tests/test_moe_ep.py``'s fallback contract: with no rules active
  ``moe_ffn_ep`` equals ``moe_ffn`` exactly. Its other contracts (EP
  against ``moe_ffn`` on 2-rank meshes, gradients included, and
  deepseek's smoke config with ``moe_impl="ep"``) run in the gloo world
  of ``tests/test_torch_sharded_chains.py``.
* A MoE serving decode step under the CPU stand-in for CUDA-graph capture
  (``tests/_capture_emulation.py``, where a host read raises): the tokens
  of the captured run equal those under ``disable_capture()``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as jattn
from repro.nn import moe as jmoe
from repro.nn.common import Initializer as JInitializer
from repro_torch import configs as tconfigs
from repro_torch.nn import attention as tattn
from repro_torch.nn import moe as tmoe
from repro_torch.nn.common import Initializer
import _torch_dist
from _capture_emulation import emulate_capture
from _jax_reference import _reference_compiled_unoptimised  # noqa: F401
from _jax_reference import moe_ffn_reference

E, K = _torch_dist.MOE["n_experts"], _torch_dist.MOE["top_k"]


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


def _gate_order(params, x):
    """Each token's gates, largest first, from the float32 router."""
    logits = x.reshape(-1, x.shape[-1]).astype(np.float64) @ params["router"]
    g = np.exp(logits - logits.max(-1, keepdims=True))
    return -np.sort(-(g / g.sum(-1, keepdims=True)), axis=-1)


@pytest.mark.parametrize("factor", [1.25, E / K])
def test_moe_ffn_value_and_gradients_match_reference(factor):
    params, x, w = _torch_dist.moe_case()
    gates = _gate_order(params, x)
    assert float((gates[:, K - 1] - gates[:, K]).min()) > 1e-4
    dropped = _torch_dist.moe_drops(params, x, factor)
    assert (dropped > 0) if factor == 1.25 else (dropped == 0)
    want_y, want_g = moe_ffn_reference(factor)
    p, xt = (_torch_dist.as_leaf_tensors(t) for t in (params, x))
    y = tmoe.moe_ffn(p, xt, top_k=K, capacity_factor=factor)
    assert y.shape == x.shape and y.dtype == torch.float32
    _close(y.detach(), want_y)
    got = torch.autograd.grad((y * torch.as_tensor(w)).sum(),
                              _torch_dist.moe_leaves(p) + [xt])
    assert len(got) == len(want_g) == 8
    for a, b in zip(got, want_g):
        _close(a, b)


def test_moe_init_keeps_the_reference_fan_in():
    """The experts' w_gate and w_up take their first dim (E) as fan-in,
    as the JAX package's ``Initializer.dense`` default gives them."""
    init = Initializer(3, torch.float32, "cpu")
    p = tmoe.init_moe_params(init, "m", 256, 512, 64)
    shapes = jax.eval_shape(functools.partial(
        jmoe.init_moe_params, JInitializer(0, jnp.float32), "m", 256, 512,
        64))
    for a, b in zip(_torch_dist.moe_leaves(p),
                    jax.tree_util.tree_leaves(shapes)):
        assert tuple(a.shape) == tuple(b.shape)
    ex = p["experts"]
    assert abs(float(ex["w_gate"].std()) - 1 / 8) < 2e-3
    assert abs(float(ex["w_up"].std()) - 1 / 8) < 2e-3
    assert abs(float(ex["w_down"].std()) - 1 / 512 ** 0.5) < 2e-3


def test_moe_ep_without_rules_falls_back_to_moe_ffn_exactly():
    params, x, _ = _torch_dist.moe_case()
    p = _torch_dist.as_leaf_tensors(params)
    with torch.no_grad():
        a = tmoe.moe_ffn_ep(p, torch.as_tensor(x), top_k=K)
        b = tmoe.moe_ffn(p, torch.as_tensor(x), top_k=K)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------
MLA = dict(d_model=32, n_heads=4, kv_lora=16, qk_nope=8, qk_rope=4,
           v_head=8)


def test_mla_attention_matches_reference_with_and_without_a_cache():
    B, S = 2, 9
    init = Initializer(5, torch.float32, "cpu")
    tp = tattn.init_mla_params(init, "mla", **MLA)
    jp = jax.tree_util.tree_map(jnp.asarray, _torch_dist.as_numpy(tp))
    x = (np.random.default_rng(2).standard_normal((B, S, MLA["d_model"]))
         .astype(np.float32))
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))

    def jax_run(p, x):
        full, _ = jattn.mla_attention(p, x, positions=jnp.asarray(pos))
        cache = jattn.make_mla_cache(B, S, MLA["kv_lora"], MLA["qk_rope"],
                                     jnp.float32)
        pre, cache = jattn.mla_attention(p, x[:, :-1], positions=jnp.asarray(
            pos[:, :-1]), cache=cache)
        dec, cache = jattn.mla_attention(p, x[:, -1:], positions=jnp.asarray(
            pos[:, -1:]), cache=cache)
        return full, pre, dec, cache["c_kv"], cache["k_rope"], cache["pos"]

    want = [np.asarray(a) for a in jax.jit(jax_run)(jp, jnp.asarray(x))]
    xt, tpos = torch.as_tensor(x), torch.as_tensor(pos)
    full, none = tattn.mla_attention(tp, xt, positions=tpos)
    assert none is None
    cache = tattn.make_mla_cache(B, S, MLA["kv_lora"], MLA["qk_rope"],
                                 torch.float32, "cpu")
    pre, cache2 = tattn.mla_attention(tp, xt[:, :-1], positions=tpos[:, :-1],
                                      cache=cache)
    assert cache2["c_kv"] is cache["c_kv"]  # written in place
    dec, cache3 = tattn.mla_attention(tp, xt[:, -1:], positions=tpos[:, -1:],
                                      cache=cache2)
    got = [full, pre, dec, cache3["c_kv"], cache3["k_rope"], cache3["pos"]]
    for a, b in zip(got, want):
        _close(a.detach(), b)
    _close(dec[:, 0].detach(), full[:, -1].detach())
    # the write offset clamps as dynamic_update_slice's start does: a
    # two-token write at offset S - 1 lands at S - 2
    c = tattn.make_mla_cache(B, S, MLA["kv_lora"], MLA["qk_rope"],
                             torch.float32, "cpu")
    c["pos"].fill_(S - 1)
    _, c = tattn.mla_attention(tp, xt[:, :2], positions=tpos[:, :2], cache=c)
    assert float(c["c_kv"][:, S - 2:].abs().sum()) > 0
    assert float(c["c_kv"][:, :S - 2].abs().sum()) == 0


# ---------------------------------------------------------------------------
# the MoE decode step captured
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "granite-moe-1b-a400m"])
def test_moe_decode_step_captured_matches_eager(monkeypatch, arch):
    from repro_torch.core.program import GRAPH_COUNTS, disable_capture
    from repro_torch.launch.serve import serve_batch
    from repro_torch.nn import lm

    emulate_capture(monkeypatch)
    cfg = tconfigs.get_smoke_config(arch)
    params = lm.init_params(cfg, seed=2, device="cpu")
    prompts = torch.randint(0, cfg.vocab, (3, 12),
                            generator=torch.Generator().manual_seed(4))
    kw = dict(cfg=cfg, params=params, prompts=prompts, max_new=6,
              device="cpu")
    for temperature in (0.0, 1.0):
        c0, r0 = GRAPH_COUNTS["captures"], GRAPH_COUNTS["replays"]
        got, _ = serve_batch(arch, temperature=temperature, **kw)
        assert GRAPH_COUNTS["captures"] - c0 == 1
        # the capture's own call replays the graph, as do the three after
        assert GRAPH_COUNTS["replays"] - r0 == 4
        with disable_capture():
            want, _ = serve_batch(arch, temperature=temperature, **kw)
        assert torch.equal(got, want), temperature
