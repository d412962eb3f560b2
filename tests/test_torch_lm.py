"""PyTorch port: the LM substrate (``repro_torch.nn``, ``configs``,
``models.bayes_lm``, ``launch.serve``) held against the JAX package.

The same weights go through both packages: the port's seeded
``init_params`` (the JAX package's law, fan-in scaled normals) carried
into the JAX package's pytree key for key, as NumPy; the JAX package's own
``init_params`` (its initialiser keys on Python's salted ``hash``, so its
weights cannot be re-derived from a seed) is carried the other way by
``repro_torch.convert.params_from_reference`` where that conversion is
the point, and every ported arch's init tree (its shapes from
``jax.eval_shape``) is carried across with seeded values. Tokens and frames are made with NumPy. Each JAX computation
runs as one compiled program (``jax.jit``). Smoke configs in float32;
tolerances: logits at rtol and atol 1e-4 (float32 products and softmaxes
in another order over a few layers, logits up to ~60), densities at rtol
1e-5. On the CPU the flash route runs the kernels' plain versions; the
JAX side runs its plain attention and scan (``attn_impl="xla"``) for
both of the port's routes, since the JAX package's own tests hold its
Pallas kernels to those.

The ring-buffer prefill is where the port departs from the JAX package on
purpose: the JAX package attends over a ring it has already overwritten
when the prompt is at least as long as the ring (ROADMAP Queue 3); the
port's prefill past the window equals ``forward_train``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.contexts import LikelihoodContext as JLikelihoodContext
from repro.core.contexts import MiniBatchContext as JMiniBatchContext
from repro.core.contexts import PriorContext as JPriorContext
from repro.models import bayes_lm as jbayes
from repro.models import paper_suite as jsuite
from repro.nn import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_reference, state_from_reference
from repro_torch.core.contexts import (LikelihoodContext, MiniBatchContext,
                                       PriorContext)
from repro_torch.launch.serve import serve_batch
from repro_torch.models import bayes_lm as tbayes
from repro_torch.models import paper_suite as tsuite
from repro_torch.nn import lm as tlm
from _jax_reference import _reference_compiled_unoptimised  # noqa: F401


PORTED = ["smollm-360m", "minitron-4b", "granite-8b", "gemma2-27b",
          "internvl2-26b", "seamless-m4t-large-v2", "mamba2-1.3b"]
LATER = ["deepseek-v2-lite-16b", "granite-moe-1b-a400m", "recurrentgemma-9b"]


def _close(got, want, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


@functools.lru_cache(maxsize=None)
def _params(arch, seed):
    """The port's weights and the JAX package's copy of them, made once a
    module for each (arch, seed): the attention route does not change
    them, and no test does."""
    tp = tlm.init_params(tconfigs.get_smoke_config(arch), seed=seed,
                         device="cpu")
    dtype = jconfigs.get_smoke_config(arch).dtype
    jp = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.to(torch.float32).numpy(), dtype), tp)
    return jp, tp



@functools.lru_cache(maxsize=None)
def _pair(arch, impl="xla", seed=0):
    """(jax cfg, jax params, port cfg, port params): the same weights."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                               attn_impl=impl)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                               attn_impl=impl)
    jp, tp = _params(arch, seed)
    return jcfg, jp, tcfg, tp


def _inputs(cfg, B, S, seed=0):
    """Tokens and the modality extras, as NumPy, for both packages."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    extras = {}
    if cfg.enc_layers > 0:
        extras["enc_frames"] = (0.1 * rng.standard_normal(
            (B, cfg.n_prefix, cfg.d_model))).astype(np.float32)
    elif cfg.n_prefix > 0:
        extras["prefix_embeds"] = (0.1 * rng.standard_normal(
            (B, cfg.n_prefix, cfg.d_model))).astype(np.float32)
    return tokens, labels, extras


def _jx(extras):
    return {k: jnp.asarray(v) for k, v in extras.items()}


def _jax_prefill_decode(cfg, B, S, n_prefix):
    """The JAX package's ``forward_train`` over S tokens, ``prefill`` of
    the first S - 1 and ``decode_step`` of the last, as one function for
    ``jax.jit``: the same arithmetic as op-by-op dispatch, in a fraction
    of the time on the CPU."""
    def run(params, tokens, extras):
        full = jlm.forward_train(cfg, params, tokens, **extras)
        cache = jlm.init_cache(cfg, B, S + n_prefix)
        logits, cache = jlm.prefill(cfg, params, tokens[:, :-1], cache,
                                    **extras)
        memory = None
        if cfg.enc_layers:
            memory = jlm.make_cross_kv(cfg, params, jlm.encode(
                cfg, params, extras["enc_frames"]))
        pos = jnp.full((B,), S - 1 + n_prefix, jnp.int32)
        step, _ = jlm.decode_step(cfg, params, tokens[:, -1:], cache, pos,
                                  memory_kv=memory)
        return full, logits, step
    return run


@functools.lru_cache(maxsize=None)
def _jax_reference(arch, B=2, S=16):
    """The JAX package's logits for ``arch``'s smoke config through its
    plain route: ``forward_train`` over S tokens, ``prefill`` of S - 1,
    ``decode_step`` of the last (NumPy), once a module: both of the port's
    routes are held to them."""
    jcfg, jp, _, _ = _pair(arch, "xla")
    tokens, _, extras = _inputs(jcfg, B, S)
    n_prefix = jcfg.n_prefix if jcfg.n_prefix and not jcfg.enc_layers else 0
    run = jax.jit(_jax_prefill_decode(jcfg, B, S, n_prefix))
    return tuple(np.asarray(a)
                 for a in run(jp, jnp.asarray(tokens), _jx(extras)))


def _th(extras):
    return {k: torch.as_tensor(v) for k, v in extras.items()}


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", list(jconfigs.ARCH_NAMES))
def test_configs_equal_the_reference(arch):
    to_torch = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    for get in ("get_config", "get_smoke_config"):
        j = getattr(jconfigs, get)(arch)
        t = getattr(tconfigs, get)(arch)
        for f in dataclasses.fields(t):
            want = getattr(j, f.name)
            if f.name == "dtype":
                want = to_torch[want]
            assert getattr(t, f.name) == want, (arch, get, f.name)
    assert tconfigs.ARCH_NAMES == jconfigs.ARCH_NAMES
    assert tconfigs.skip_reason(arch, "long_500k") == \
        jconfigs.skip_reason(arch, "long_500k")
    assert tconfigs.cells(include_skipped=True) == \
        jconfigs.cells(include_skipped=True)


@pytest.mark.parametrize("arch", LATER)
def test_unported_blocks_raise_naming_the_roadmap_item(arch):
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        tlm.init_params(tconfigs.get_smoke_config(arch), device="meta")


def test_params_carry_across_key_for_key_and_are_seeded_by_path():
    jcfg, _, tcfg, _ = _pair("gemma2-27b")
    # the JAX package's own init, one program, carried across
    jp = jax.jit(functools.partial(jlm.init_params, jcfg, 0))()
    tp = params_from_reference(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                               device="cpu")
    assert tlm.count_params(tp) == jlm.count_params(jp)
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(tp)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a, np.float32))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tree["segments"][0][0]["attn"].pop("wq")
    with pytest.raises(ValueError, match="segments/0/0/attn: keys"):
        params_from_reference(tree, tcfg, device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tree["final_norm"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="final_norm: shape"):
        params_from_reference(tree, tcfg, device="cpu")
    # the port's own init: the same weights in every process, from the seed
    a = tlm.init_params(tcfg, seed=3, device="cpu")
    b = tlm.init_params(tcfg, seed=3, device="cpu")
    torch.testing.assert_close(a["segments"][0][1]["attn"]["wq"],
                               b["segments"][0][1]["attn"]["wq"], rtol=0,
                               atol=0)
    assert not torch.equal(a["segments"][0][0]["attn"]["wq"],
                           a["segments"][0][1]["attn"]["wq"])


@pytest.mark.parametrize("arch", PORTED)
def test_params_from_reference_takes_the_reference_init_tree(arch):
    """The JAX package's ``init_params`` tree for each ported arch (its
    keys, shapes and dtypes from ``jax.eval_shape``, no compile), filled
    with seeded NumPy values, carries across key for key: the port's own
    init has the same keys and shapes, and every value arrives."""
    jcfg = jconfigs.get_smoke_config(arch)
    tcfg = tconfigs.get_smoke_config(arch)
    shapes = jax.eval_shape(functools.partial(jlm.init_params, jcfg, 0))
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    tp = params_from_reference(tree, tcfg, device="cpu")
    own = tlm.init_params(tcfg, device="meta")
    assert (jax.tree_util.tree_structure(tp)
            == jax.tree_util.tree_structure(own))
    for a, b, c in zip(jax.tree_util.tree_leaves(tree),
                       jax.tree_util.tree_leaves(tp),
                       jax.tree_util.tree_leaves(own)):
        assert tuple(b.shape) == tuple(c.shape) and b.dtype == c.dtype
        want = torch.as_tensor(a).to(b.dtype)  # the parameter's type
        torch.testing.assert_close(b, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# forward, prefill and decode against the JAX package
# ---------------------------------------------------------------------------
CASES = [(a, "xla") for a in PORTED] + [("gemma2-27b", "flash"),
                                        ("mamba2-1.3b", "flash")]


@pytest.mark.parametrize("arch,impl", CASES)
def test_forward_prefill_decode_match_reference(arch, impl):
    jcfg, _, tcfg, tp = _pair(arch, impl)
    B, S = 2, 16
    tokens, _, extras = _inputs(jcfg, B, S)
    n_prefix = jcfg.n_prefix if jcfg.n_prefix and not jcfg.enc_layers else 0
    want, jl, jd = _jax_reference(arch, B, S)
    got = tlm.forward_train(tcfg, tp, torch.as_tensor(tokens), **_th(extras))
    assert got.dtype == torch.float32 and got.shape == (B, S, jcfg.vocab)
    _close(got, want)

    tc = tlm.init_cache(tcfg, B, S + n_prefix, device="cpu")
    tl, tc = tlm.prefill(tcfg, tp, torch.as_tensor(tokens[:, :-1]), tc,
                         **_th(extras))
    _close(tl, jl)
    tm = None
    if jcfg.enc_layers:
        tm = tlm.make_cross_kv(tcfg, tp, tlm.encode(
            tcfg, tp, torch.as_tensor(extras["enc_frames"])))
    pos = np.full((B,), S - 1 + n_prefix, np.int32)
    td, _ = tlm.decode_step(tcfg, tp, torch.as_tensor(tokens[:, -1:]), tc,
                            torch.as_tensor(pos), memory_kv=tm)
    _close(td, jd)
    # and the port's own prefill + decode against its forward (2e-3, as
    # test_archs.py holds the JAX package)
    _close(td[:, 0], got[:, -1], rtol=2e-3, atol=2e-3)


def test_lm_loss_matches_reference():
    jcfg, jp, tcfg, tp = _pair("smollm-360m")
    tokens, labels, _ = _inputs(jcfg, 2, 8)
    want = float(jax.jit(functools.partial(jlm.lm_loss, jcfg))(
        jp, jnp.asarray(tokens), jnp.asarray(labels)))
    got = float(tlm.lm_loss(tcfg, tp, torch.as_tensor(tokens),
                            torch.as_tensor(labels)))
    _close(got, want, rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# the ring-buffer prefill (gemma2 smoke: window 16, a 16-slot ring)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S", [12, 17, 24, 40])
def test_ring_prefill_past_the_window_matches_forward(S):
    jcfg, jp, _, _ = _pair("gemma2-27b", "xla", seed=2)
    _, _, tcfg, tp = _pair("gemma2-27b", "flash", seed=2)
    assert tcfg.window == 16
    B = 2
    tokens, _, _ = _inputs(jcfg, B, S + 1, seed=S)

    def jax_ring(params, tokens):  # one compiled program
        cache = jlm.init_cache(jcfg, B, S + 1)
        return (jlm.forward_train(jcfg, params, tokens),
                jlm.prefill(jcfg, params, tokens[:, :S], cache)[0])

    jfull, jl = (np.asarray(a)
                 for a in jax.jit(jax_ring)(jp, jnp.asarray(tokens)))
    full = tlm.forward_train(tcfg, tp, torch.as_tensor(tokens))
    _close(full, jfull)

    tc = tlm.init_cache(tcfg, B, S + 1, device="cpu")
    # the local layers' ring (stacked over the 2 super-blocks)
    assert tc[0][0]["k"].shape[2] == min(S + 1, 16)
    tl, tc = tlm.prefill(tcfg, tp, torch.as_tensor(tokens[:, :S]), tc)
    _close(tl[:, 0], full[:, S - 1], rtol=2e-3, atol=2e-3)
    _close(tl[:, 0], jfull[:, S - 1], rtol=2e-3, atol=2e-3)
    td, _ = tlm.decode_step(tcfg, tp, torch.as_tensor(tokens[:, S:]), tc,
                            torch.full((B,), S, dtype=torch.int32))
    _close(td[:, 0], jfull[:, S], rtol=2e-3, atol=2e-3)

    if S < 16:  # the JAX package is right here: the port equals it
        _close(tl, jl)
    else:       # and wrong here (ROADMAP Queue 3)
        assert float(np.abs(np.asarray(jl)[:, 0]
                            - jfull[:, S - 1]).max()) > 0.1


# ---------------------------------------------------------------------------
# the Bayesian LM and serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,impl", [("smollm-360m", "xla"),
                                       ("mamba2-1.3b", "flash")])
def test_lm_model_contexts_match_reference(arch, impl):
    """test_train_serve.py's context checks, with values equal to the JAX
    package's (its plain route) at rtol 1e-5."""
    jcfg, jp, _, _ = _pair(arch, "xla")
    _, _, tcfg, tp = _pair(arch, impl)
    tokens, labels, _ = _inputs(jcfg, 2, 8)
    jm = jbayes.make_lm_model(jcfg, prior_sigma=1.0)(
        tokens=jnp.asarray(tokens), labels=jnp.asarray(labels), params=jp)
    tm = tbayes.make_lm_model(tcfg, prior_sigma=1.0)(
        tokens=torch.as_tensor(tokens), labels=torch.as_tensor(labels),
        params=tp)
    pairs = [(JPriorContext(), PriorContext()),
             (JLikelihoodContext(), LikelihoodContext()),
             (JMiniBatchContext(scale=7.0), MiniBatchContext(scale=7.0))]
    # every context and the log-joint compiled as one program: the same
    # arithmetic as op by op
    wants = jax.jit(lambda: [jm.logp_with_context({}, jctx)
                             for jctx, _ in pairs] + [jm.logjoint({})])()
    got = {}
    for (_, tctx), want in zip(pairs, wants):
        got[type(tctx).__name__] = g = float(tm.logp_with_context({}, tctx))
        _close(g, float(want), rtol=1e-5, atol=0)
    lj = float(tm.logjoint({}))
    _close(lj, float(wants[-1]), rtol=1e-5, atol=0)
    lp, ll = got["PriorContext"], got["LikelihoodContext"]
    assert np.isclose(lj, lp + ll, rtol=1e-5)
    assert np.isclose(got["MiniBatchContext"], lp + 7.0 * ll, rtol=1e-5)
    want = float(tbayes.tree_normal_logprior(tp, 1.0))
    assert np.isclose(lp, want, rtol=1e-6)


def test_logp_with_context_matches_reference_on_a_paper_model():
    jm = jsuite.build("logreg", n=256, dim=8)
    tm = tsuite.build("logreg", device="cpu", n=256, dim=8)
    jlinked = jax.jit(lambda key: jm.model.typed_varinfo(key).link())(
        jax.random.PRNGKey(0))
    tlinked = tm.model.typed_varinfo(torch.Generator().manual_seed(0)).link()
    rng = np.random.default_rng(1)
    u = (np.asarray(jlinked.flat())
         + 0.3 * rng.normal(size=jlinked.num_flat)).astype(np.float32)
    jt = jlinked.replace_flat(jnp.asarray(u))
    sig = tuple((s.name, tuple(s.shape), s.unc_offset, s.unc_size)
                for s in jlinked.layout.sites)
    tt = state_from_reference(tlinked, u, sig)
    pairs = [(JMiniBatchContext(scale=3.0), MiniBatchContext(scale=3.0)),
             (JPriorContext(), PriorContext()),
             (JLikelihoodContext(), LikelihoodContext())]
    wants = jax.jit(lambda t: [jm.model.logp_with_context(t, jctx)
                               for jctx, _ in pairs])(jt)
    for (_, tctx), want in zip(pairs, wants):
        want = float(want)
        for backend in ("fused", "reference"):
            got = float(tm.model.logp_with_context(tt, tctx, backend=backend))
            _close(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-1.3b",
                                  "gemma2-27b"])
def test_serve_batch_shapes(arch):
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                              attn_impl="flash")
    gen, stats = serve_batch(arch, cfg=cfg, batch=2, prompt_len=20,
                             max_new=4, device="cpu")
    assert gen.shape == (2, 4) and gen.dtype == torch.int32
    assert bool(((gen >= 0) & (gen < cfg.vocab)).all())
    assert stats["prefill_s"] > 0 and stats["tokens_per_s"] > 0


def test_serve_greedy_tokens_follow_the_forward():
    """Greedy serving is argmax of forward_train over the growing prompt."""
    cfg = tconfigs.get_smoke_config("gemma2-27b")
    params = tlm.init_params(cfg, seed=1, device="cpu")
    prompts = torch.randint(0, cfg.vocab, (2, 18),
                            generator=torch.Generator().manual_seed(0))
    gen, _ = serve_batch("gemma2-27b", cfg=cfg, params=params,
                         prompts=prompts, max_new=3, device="cpu")
    seq = prompts
    for i in range(3):
        nxt = tlm.forward_train(cfg, params, seq)[:, -1].argmax(-1)
        assert torch.equal(gen[:, i], nxt.to(torch.int32))
        seq = torch.cat([seq, nxt[:, None]], dim=1)


def test_lm_entry_points_default_to_cuda_and_never_fall_back(monkeypatch):
    from repro_torch import _device
    monkeypatch.setattr(_device.torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_smoke_config("smollm-360m")
    for call in (lambda: tlm.init_params(cfg),
                 lambda: tlm.init_cache(cfg, 1, 8),
                 lambda: serve_batch("smollm-360m", max_new=2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_nn_common_inits_and_layer_norm_match_reference():
    from repro.nn import common as jcommon
    from repro_torch.nn import common as tcommon
    for name in ("dense_init", "embed_init", "layer_norm"):
        assert name in tcommon.__all__ and name in jcommon.__all__
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32) * 2.0 + 0.5
    scale = rng.standard_normal(48).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    want = jax.jit(jcommon.layer_norm)(jnp.asarray(x), jnp.asarray(scale),
                                       jnp.asarray(bias))
    got = tcommon.layer_norm(torch.as_tensor(x), torch.as_tensor(scale),
                             torch.as_tensor(bias))
    assert got.dtype == torch.float32
    _close(got, want, rtol=1e-5, atol=1e-5)
    xb = torch.as_tensor(x).to(torch.bfloat16)
    assert tcommon.layer_norm(xb, torch.as_tensor(scale),
                              torch.as_tensor(bias)).dtype == torch.bfloat16
    # the inits: the reference's shapes, types and laws (Philox, not
    # threefry, so the draws themselves differ)
    shape = (256, 512)
    wj = jax.eval_shape(lambda key: jcommon.dense_init(key, shape),
                        jax.random.PRNGKey(0))
    wt = tcommon.dense_init(torch.Generator().manual_seed(0), shape)
    et = tcommon.embed_init(torch.Generator().manual_seed(0), shape,
                            dtype=torch.float32)
    assert tuple(wt.shape) == tuple(wj.shape) == shape
    assert wt.dtype == torch.bfloat16 and et.dtype == torch.float32
    assert abs(float(wt.float().std()) - 1 / 16) < 2e-3
    assert abs(float(et.std()) - 1.0) < 2e-2
    assert abs(float(et.mean())) < 2e-2
    again = tcommon.dense_init(torch.Generator().manual_seed(0), shape)
    assert torch.equal(wt, again)
