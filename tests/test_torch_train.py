"""PyTorch port: Bayesian-LM training (``repro_torch.data``,
``models.bayes_lm.make_train_step``/``TrainState``, remat in ``nn.lm``,
``launch.train``, SGLD over an LM's weights) held against the JAX package.

The same weights go through both packages: the port's seeded
``init_params`` carried into the JAX package's tree (``_jax_params``: the
JAX package's own init keys on Python's salted ``hash``, ROADMAP Queue 3 C,
so its weights change from one process to the next and a tolerance met in
one run could be missed in another), carried back into the port by
``convert.params_from_reference``, and one NumPy batch. Each JAX
computation is one ``jax.jit`` program that returns the step's metrics, new
state and the gradient it clipped (read at ``optim.clip_by_global_norm``,
stubbed for the trace), so one compile an architecture serves every
comparison. Smoke configs in float32. Tolerances: metrics at rtol 1e-5; the
gradient (``jax.value_and_grad`` of the scaled log-joint) at 1e-5 of each
leaf's max |g|; after one AdamW step the params at atol 1e-6 + rtol 1e-5
(Adam's first step moves an entry by about lr·sign(g), so entries whose
reference gradient is within 1e-4 of its leaf's max of 0 — float32 noise
for the sign — are masked); after one SGLD step at temperature 0 (plain,
step_size * g) the moves at 1e-5 of each leaf's max move plus two float32
ulps of the parameter. The port's own contracts (``train()``,
microbatching, remat, resume) are port against port, on the CPU.
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ckpt as jckpt
from repro import configs as jconfigs
from repro import optim as joptim
from repro.infer.sgld import SGLD as JSGLD
from repro.infer.sgld import make_sgld_step as jmake_sgld_step
from repro.models import bayes_lm as jbayes
from repro_torch import ckpt as tckpt
from repro_torch import configs as tconfigs
from repro_torch import optim as toptim
from repro_torch.convert import params_from_reference
from repro_torch.core.contexts import MiniBatchContext
from repro_torch.data import ShapeDtype, SyntheticTokens, host_shard
from repro_torch.infer.sgld import SGLD, make_sgld_step
from repro_torch.launch import train as ttrain
from repro_torch.models import bayes_lm as tbayes
from repro_torch.nn import lm as tlm
from _jax_reference import _reference_compiled_unoptimised  # noqa: F401

ARCHS = ["smollm-360m", "mamba2-1.3b"]
TOTAL_TOKENS = 1e6
# deterministic SGLD; without the preconditioner the move is step_size * g,
# so the gradient's gate carries over to it exactly
SGLD_T0 = dict(step_size=1e-6, temperature=0.0, precondition=False)
LR = 3e-4  # make_train_step's default learning rate


def _ds(**kw):
    return SyntheticTokens(device="cpu", **kw)


# ---------------------------------------------------------------------------
# data: tests/test_substrate.py's five contracts on the port's pipeline
# ---------------------------------------------------------------------------
def test_data_deterministic_across_restarts():
    ds = _ds(vocab=1000, seq_len=64, global_batch=8, seed=7)
    a, b = ds.batch(step=123), ds.batch(step=123)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], ds.batch(step=124)["tokens"])
    # a pure function of (seed, step): another instance, another seed
    assert torch.equal(_ds(vocab=1000, seq_len=64, global_batch=8,
                           seed=7).batch(123)["labels"], a["labels"])
    assert not torch.equal(_ds(vocab=1000, seq_len=64, global_batch=8,
                               seed=8).batch(123)["tokens"], a["tokens"])


def test_data_host_shards_tile_global_batch():
    ds = _ds(vocab=1000, seq_len=32, global_batch=8, seed=0)
    full = ds.batch(step=5, host_id=0, num_hosts=1)
    parts = [ds.batch(step=5, host_id=h, num_hosts=4)["tokens"]
             for h in range(4)]
    assert torch.equal(torch.cat(parts, 0), full["tokens"])


def test_data_elastic_host_count_change_preserves_stream():
    ds = _ds(vocab=500, seq_len=16, global_batch=8, seed=3)
    two = torch.cat([ds.batch(9, h, 2)["tokens"] for h in range(2)], 0)
    eight = torch.cat([ds.batch(9, h, 8)["tokens"] for h in range(8)], 0)
    assert torch.equal(two, eight)


def test_data_labels_are_shifted_tokens():
    ds = _ds(vocab=100, seq_len=16, global_batch=2, seed=1)
    b = ds.batch(0)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_host_shard_validation():
    with pytest.raises(ValueError):
        host_shard(10, 0, 3)


def test_data_law_and_spec():
    """Ids in [1, vocab - 1) skewed to the low end, EOS at 1/mean_doc_len,
    int32, and ``spec`` giving shapes and types."""
    ds = _ds(vocab=1000, seq_len=256, global_batch=64, seed=2,
             mean_doc_len=16)
    toks = ds.batch(0)["tokens"]
    assert toks.dtype == torch.int32 and toks.shape == (64, 256)
    eos = (toks == 0).float().mean().item()
    assert abs(eos - 1 / 16) < 0.01
    ids = toks[toks != 0]
    assert ids.min() >= 1 and ids.max() < 999
    # squared uniform: P(id < vocab/4) = P(u < 1/2) = 1/2
    assert abs((ids < 250).float().mean().item() - 0.5) < 0.02
    assert ds.spec(1, 4) == {"tokens": ShapeDtype((16, 256), torch.int32),
                             "labels": ShapeDtype((16, 256), torch.int32)}


# ---------------------------------------------------------------------------
# one step of make_train_step against repro's
# ---------------------------------------------------------------------------
def _np_batch(vocab, rows=4, seq=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (rows, seq)).astype(np.int32),
            "labels": rng.integers(0, vocab, (rows, seq)).astype(np.int32)}


def _stub_clip(monkeypatch, module, seen):
    """Record the tree ``module.clip_by_global_norm`` is given."""
    real = module.clip_by_global_norm

    def clip(tree, max_norm):
        seen.append(tree)
        return real(tree, max_norm)

    monkeypatch.setattr(module, "clip_by_global_norm", clip)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    """The port's seeded init as the JAX package's tree of arrays (the
    port keeps its structure key for key)."""
    tp = tlm.init_params(tconfigs.get_smoke_config(arch), seed=0,
                         device="cpu")
    dtype = jconfigs.get_smoke_config(arch).dtype
    return jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.to(torch.float32).numpy(), dtype), tp)


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """repro's one MAP and one SGLD step from ``_jax_params``, as NumPy:
    {mode: (params, batch, new params, metrics, clipped tree)}, both from
    one jitted program."""
    cfg = jconfigs.get_smoke_config(arch)
    params = _jax_params(arch)
    batch = _np_batch(cfg.vocab)
    steps = {mode: jbayes.make_train_step(
        cfg, total_tokens=TOTAL_TOKENS, mode=mode,
        sgld=JSGLD(**SGLD_T0) if mode == "sgld" else None)
        for mode in ("map", "sgld")}
    mp = pytest.MonkeyPatch()
    seen = []
    _stub_clip(mp, joptim, seen)
    try:
        def f(p, key, b):
            out = {}
            for mode, (init_fn, step_fn) in steps.items():
                new, metrics = step_fn(init_fn(p), key, b)
                out[mode] = (new.params, metrics, seen[-1])
            return out
        out = jax.jit(f)(params, jax.random.PRNGKey(0),
                         jax.tree_util.tree_map(jnp.asarray, batch))
    finally:
        mp.undo()
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return {mode: (to_np(params), batch, to_np(new),
                   {k: float(v) for k, v in metrics.items()}, to_np(clipped))
            for mode, (new, metrics, clipped) in out.items()}


def _port_step(arch, mode, monkeypatch, ref_params, batch, **kw):
    cfg = tconfigs.get_smoke_config(arch)
    params = params_from_reference(ref_params, cfg, device="cpu")
    sgld = SGLD(**SGLD_T0) if mode == "sgld" else None
    init_fn, step_fn = tbayes.make_train_step(
        cfg, total_tokens=TOTAL_TOKENS, mode=mode, sgld=sgld, **kw)
    seen = []
    _stub_clip(monkeypatch, toptim, seen)
    state = init_fn(params)
    state, metrics = step_fn(state, torch.Generator().manual_seed(0),
                             {k: torch.as_tensor(v) for k, v in batch.items()})
    return state, {k: float(v) for k, v in metrics.items()}, seen[-1]


def _pairs(port_tree, ref_tree, cfg):
    """(port leaf, reference leaf) pairs, the reference carried into the
    port's structure first."""
    ref = params_from_reference(ref_tree, cfg, device="cpu")
    return list(zip(tlm.tree_leaves(port_tree), tlm.tree_leaves(ref)))


@pytest.mark.parametrize("arch", ARCHS)
def test_map_step_matches_the_reference(arch, monkeypatch):
    ref_params, batch, ref_new, ref_metrics, ref_neg = \
        _reference(arch)["map"]
    state, metrics, neg = _port_step(arch, "map", monkeypatch, ref_params,
                                     batch)
    for k in ("logjoint", "nll", "grad_norm"):
        np.testing.assert_allclose(metrics[k], ref_metrics[k], rtol=1e-5,
                                   err_msg=k)
    cfg = tconfigs.get_smoke_config(arch)
    for g, want in _pairs(neg, ref_neg, cfg):  # -gradient, before clipping
        tol = 1e-5 * float(want.abs().max())
        torch.testing.assert_close(g, want, rtol=0, atol=tol)
    masks = [(g.abs() > 1e-4 * g.abs().max()) for _, g in
             _pairs(neg, ref_neg, cfg)]
    moved = 0
    for (got, want), keep in zip(_pairs(state.params, ref_new, cfg), masks):
        torch.testing.assert_close(got[keep], want[keep], rtol=1e-5,
                                   atol=1e-6)
        # a masked entry: each package moves it by at most lr (1 + wd |p|)
        assert float((got - want).abs().max()) <= 2.5 * LR
        moved += int(keep.sum())
    assert moved > 0.8 * tlm.count_params(state.params)
    assert int(state.step) == 1 and int(state.opt_state.step) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_sgld_step_at_temperature_zero_matches_the_reference(arch,
                                                             monkeypatch):
    ref_params, batch, ref_new, ref_metrics, _ = _reference(arch)["sgld"]
    state, metrics, _ = _port_step(arch, "sgld", monkeypatch, ref_params,
                                   batch)
    for k in ("logjoint", "nll", "grad_norm"):
        np.testing.assert_allclose(metrics[k], ref_metrics[k], rtol=1e-5,
                                   err_msg=k)
    cfg = tconfigs.get_smoke_config(arch)
    old = params_from_reference(ref_params, cfg, device="cpu")
    for (got, want), p0 in zip(_pairs(state.params, ref_new, cfg),
                               tlm.tree_leaves(old)):
        # the move at 1e-5 of the leaf's largest, plus two float32 ulps of
        # the parameter it lands on (each package rounds p + move once)
        d_ref = want - p0
        torch.testing.assert_close(got, want, rtol=2 ** -22,
                                   atol=1e-5 * float(d_ref.abs().max()))


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------
def _smoke_state(arch="smollm-360m", seed=3, **cfg_kw):
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch), **cfg_kw)
    return cfg, tlm.init_params(cfg, seed=seed, device="cpu")


def _clone(tree):
    return tlm.tree_map(lambda t: t.clone(), tree)


def test_grad_accumulation_matches_full_batch(monkeypatch):
    """tests/test_train_serve.py's contract: microbatch 2 and 4 give the
    step of microbatch 1 (which test_map_step_matches_the_reference holds
    against repro): the metrics at rtol 1e-5, the gradient the step clips
    at 1e-5 of each leaf's max, and the params after it as there (entries
    whose gradient is within 1e-4 of its leaf's max of 0 masked)."""
    cfg, params = _smoke_state()
    batch = {k: torch.as_tensor(v) for k, v in _np_batch(cfg.vocab).items()}
    outs = []
    for mb in (1, 2, 4):
        init_fn, step_fn = tbayes.make_train_step(
            cfg, total_tokens=TOTAL_TOKENS, mode="map", microbatch=mb)
        seen = []
        _stub_clip(monkeypatch, toptim, seen)
        state, metrics = step_fn(init_fn(_clone(params)),
                                 torch.Generator().manual_seed(0), batch)
        outs.append((metrics, state, tlm.tree_leaves(seen[-1])))
    m1, s1, g1 = outs[0]
    for mb, (metrics, state, grads) in zip((2, 4), outs[1:]):
        for k in ("logjoint", "nll", "grad_norm"):
            torch.testing.assert_close(metrics[k], m1[k], rtol=1e-5, atol=0,
                                       msg=lambda m: f"microbatch {mb} {k}: "
                                       f"{m}")
        for g, want in zip(grads, g1):
            torch.testing.assert_close(
                g, want, rtol=0, atol=1e-5 * float(want.abs().max()))
        for got, want, g in zip(tlm.tree_leaves(state.params),
                                tlm.tree_leaves(s1.params), g1):
            keep = g.abs() > 1e-4 * g.abs().max()
            torch.testing.assert_close(got[keep], want[keep], rtol=1e-5,
                                       atol=1e-6)
    with pytest.raises(ValueError, match="microbatches"):
        tbayes.make_train_step(cfg, total_tokens=1.0, microbatch=3)[1](
            tbayes.make_train_step(cfg, total_tokens=1.0)[0](params),
            torch.Generator(), batch)


@pytest.mark.parametrize("arch", ARCHS + ["seamless-m4t-large-v2"])
def test_remat_policies_agree_and_recompute(arch, monkeypatch):
    """remat off, "nothing" and "dots": the same log-joint and gradient;
    with remat each block runs again in the backward (seamless: the
    encoder's layers under remat too, and the decoder's cross
    attention)."""
    calls = []
    real = tlm._apply_block
    monkeypatch.setattr(tlm, "_apply_block",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = {}
    for remat, policy in ((False, "nothing"), (True, "nothing"),
                          (True, "dots")):
        cfg, params = _smoke_state(arch, remat=remat, remat_policy=policy)
        batch = {k: torch.as_tensor(v)
                 for k, v in _np_batch(cfg.vocab).items()}
        if cfg.enc_layers:
            batch["enc_frames"] = 0.1 * torch.randn(
                4, cfg.n_prefix, cfg.d_model,
                generator=torch.Generator().manual_seed(1))
        live = [p.requires_grad_(True) for p in tlm.tree_leaves(params)]
        m = tbayes.make_lm_model(cfg)(params=params, **batch)
        calls.clear()
        lp = m.logp_with_context({}, MiniBatchContext(scale=100.0))
        grads = torch.autograd.grad(lp, live)
        out[(remat, policy)] = (lp.detach(), grads, len(calls))
    lp0, g0, n0 = out[(False, "nothing")]
    assert n0 == cfg.n_layers
    for key in ((True, "nothing"), (True, "dots")):
        lp, grads, n = out[key]
        assert n == 2 * cfg.n_layers, key
        torch.testing.assert_close(lp, lp0, rtol=1e-6, atol=0)
        for a, b in zip(grads, g0):
            torch.testing.assert_close(a, b, rtol=0,
                                       atol=1e-6 * float(b.abs().max()))
    cfg, params = _smoke_state(remat=True, remat_policy="everything")
    with pytest.raises(ValueError, match="remat_policy"):
        tlm.forward_train(cfg, params, torch.zeros((1, 4), dtype=torch.int32))


def test_train_reduces_nll():
    _, hist = ttrain.train("smollm-360m", smoke=True, steps=40, batch=4,
                           seq=32, lr=2e-3, log_every=10, device="cpu")
    assert hist[-1][1] < hist[0][1]


def test_train_checkpoint_resume_equals_uninterrupted(tmp_path):
    """tests/test_train_serve.py's resume contract; then a 14-step run
    preempted after step 10 and resumed equal to an uninterrupted one bit
    for bit (MAP: the step draws nothing)."""
    from repro_torch.runtime import ScriptedPreemption
    d = str(tmp_path / "run")
    kw = dict(smoke=True, batch=2, seq=16, ckpt_every=5, device="cpu")
    ttrain.train("smollm-360m", steps=10, ckpt_dir=d, log_every=5, **kw)
    assert tckpt.latest_step(d) == 10
    _, hist = ttrain.train("smollm-360m", steps=14, ckpt_dir=d, log_every=2,
                           **kw)
    assert hist[0][0] > 10  # resumed: first logged step is past 10
    d2 = str(tmp_path / "preempted")
    ttrain.train("smollm-360m", steps=14, ckpt_dir=d2, log_every=2,
                 preempt=ScriptedPreemption(after_polls=9), **kw)
    assert tckpt.latest_step(d2) == 10
    resumed, hist = ttrain.train("smollm-360m", steps=14, ckpt_dir=d2,
                                 log_every=2, **kw)
    whole, whole_hist = ttrain.train("smollm-360m", steps=14, log_every=2,
                                     **kw)
    assert hist == [h for h in whole_hist if h[0] > 10]
    for a, b in zip(*(torch.utils._pytree.tree_leaves(s)
                      for s in (resumed, whole))):
        assert torch.equal(a, b)


def test_train_preemption_saves_and_exits(tmp_path):
    from repro_torch.runtime import PreemptionHandler
    d = str(tmp_path / "run")
    ph = PreemptionHandler(install=False)
    ph.trigger()
    ttrain.train("smollm-360m", smoke=True, steps=50, batch=2, seq=16,
                 ckpt_dir=d, ckpt_every=100, log_every=100, preempt=ph,
                 device="cpu")
    assert tckpt.latest_step(d) == 1


def test_train_sgld_mode_runs():
    _, hist = ttrain.train("smollm-360m", smoke=True, steps=12, batch=2,
                           seq=16, mode="sgld", log_every=6, device="cpu")
    assert len(hist) == 2 and all(np.isfinite(h[1]) for h in hist)


def test_main_trains_and_a_mesh_waits(capsys):
    assert ttrain.main(["--arch", "mamba2-1.3b", "--smoke", "--steps", "2",
                        "--batch", "2", "--seq", "8", "--log-every", "1",
                        "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[2] for ln in lines[:2]] == ["1/2", "2/2"]
    assert all(ln.startswith("[train] step") and "nll/token" in ln
               for ln in lines[:2])
    assert ttrain.make_mesh_or_none(2, 1) is None  # one process
    assert ttrain.make_mesh_or_none(1, 1).shape == {"data": 1, "model": 1}


def test_train_state_checkpoint_paths_equal_the_reference(tmp_path):
    """A TrainState's manifest (paths, shapes, dtypes) equals the one
    ``repro.ckpt.save`` writes for repro's TrainState, in both modes, and
    restores bit for bit (bfloat16 too)."""
    jcfg = jconfigs.get_smoke_config("smollm-360m")
    tcfg = tconfigs.get_smoke_config("smollm-360m")
    jparams = _jax_params("smollm-360m")
    for mode in ("map", "sgld"):
        jstate = jbayes.make_train_step(jcfg, total_tokens=1e4,
                                        mode=mode)[0](jparams)
        jckpt.save(str(tmp_path / f"j{mode}"), 1, jstate)
        tstate = tbayes.make_train_step(tcfg, total_tokens=1e4, mode=mode)[0](
            params_from_reference(jax.tree_util.tree_map(np.asarray,
                                                         jparams),
                                  tcfg, device="cpu"))
        tckpt.save(str(tmp_path / f"t{mode}"), 1, tstate)
        man = [json.load(open(os.path.join(tmp_path, f"{w}{mode}",
                                           "step_00000001",
                                           "manifest.json")))["leaves"]
               for w in "jt"]
        assert [(e["path"], e["shape"], e["dtype"]) for e in man[1]] == \
            [(e["path"], e["shape"], e["dtype"]) for e in man[0]]
        step, back = tckpt.restore(str(tmp_path / f"t{mode}"),
                                   target=tstate)
        assert step == 1 and isinstance(back, tbayes.TrainState)
        for a, b in zip(*(torch.utils._pytree.tree_leaves(s)
                          for s in (back, tstate))):
            assert torch.equal(a, b)
    # bfloat16 leaves restore bit for bit
    bf = {"w": torch.randn(3, 5).to(torch.bfloat16)}
    tckpt.save(str(tmp_path / "bf"), 2, bf)
    _, back = tckpt.restore(str(tmp_path / "bf"), target=bf)
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"],
                                                             bf["w"])


def test_make_sgld_step_runs_on_a_bayesian_lm_as_the_reference():
    """``make_sgld_step`` over a Bayesian LM whose weights are bound data,
    at temperature 0, against repro's: the same log-joint, and (as in
    repro) the weights are data, so the ``params`` value the step
    differentiates is unread and the step leaves it where it was."""
    jcfg = jconfigs.get_smoke_config("smollm-360m")
    tcfg = tconfigs.get_smoke_config("smollm-360m")
    jparams = _jax_params("smollm-360m")
    batch = _np_batch(jcfg.vocab, rows=2, seq=8)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = jbayes.make_lm_model(jcfg)(params=jparams, **jb)
    jstep = jmake_sgld_step(jm, 10.0, sgld=JSGLD(**SGLD_T0))
    s0 = JSGLD(**SGLD_T0).init(jparams)
    jp, _, jlp = jstep(jax.random.PRNGKey(0), jparams, s0, **jb)
    tparams = params_from_reference(jax.tree_util.tree_map(np.asarray,
                                                           jparams),
                                    tcfg, device="cpu")
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    tm = tbayes.make_lm_model(tcfg)(params=tparams, **tb)
    tstep = make_sgld_step(tm, 10.0, sgld=SGLD(**SGLD_T0))
    tp, _, tlp = tstep(torch.Generator().manual_seed(0), tparams,
                       SGLD(**SGLD_T0).init(tparams), **tb)
    np.testing.assert_allclose(float(tlp), float(jlp), rtol=1e-5)
    for a, b in _pairs(tp, jax.tree_util.tree_map(np.asarray, jp), tcfg):
        assert torch.equal(a, b)


def test_train_entry_points_default_to_cuda_and_never_fall_back(monkeypatch):
    from repro_torch import _device
    monkeypatch.setattr(_device.torch.cuda, "is_available", lambda: False)
    for call in (lambda: SyntheticTokens(vocab=10, seq_len=4,
                                         global_batch=2).batch(0),
                 lambda: ttrain.train("smollm-360m", steps=1, batch=2,
                                      seq=8),
                 lambda: ttrain.main(["--arch", "smollm-360m", "--smoke",
                                      "--steps", "1"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_kernel_functions_run_under_torch_func_grad():
    """The flash-attention and SSD autograd Functions in torch.func's form:
    ``torch.func.grad`` through them (their CPU forward is the plain
    version) equals ``torch.autograd`` through the plain versions."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 12, 2, 3, 16, generator=gen)
    k, v = (torch.randn(2, 12, 2, 16, generator=gen) for _ in range(2))
    pos = torch.arange(12)[None].expand(2, 12)
    kw = dict(q_positions=pos, kv_positions=pos, causal=True, window=5,
              cap=None)
    got = torch.func.grad(lambda q, k, v: fops.flash_attention_gqa(
        q, k, v, **kw).square().sum(), argnums=(0, 1, 2))(q, k, v)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*ins, **kw).square().sum(), ins)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    x = torch.randn(2, 40, 2, 8, generator=gen)
    dt = torch.rand(2, 40, 2, generator=gen) * 0.5
    A = -torch.rand(2, generator=gen) - 0.5
    B, C = (torch.randn(2, 40, 1, 4, generator=gen) for _ in range(2))
    got = torch.func.grad(lambda *a: sops.ssd_scan(*a, chunk=16).square()
                          .sum(), argnums=(0, 1, 2, 3, 4))(x, dt, A, B, C)
    ins = [t.clone().requires_grad_(True) for t in (x, dt, A, B, C)]
    want = torch.autograd.grad(ssd_scan_ref(*ins, chunk=16).square().sum(),
                               ins)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["map", "sgld"])
def test_train_step_captured_equals_eager(mode, monkeypatch):
    """The step as one program: captured at its second call (the CPU
    stand-in of ``tests/_capture_emulation.py``: the body's aten ops,
    autograd's and remat's recompute among them, recorded and replayed on
    the same tensors; a host read raises), four steps equal the same steps
    under ``disable_capture()`` bit for bit, SGLD's draws included."""
    import contextlib

    from _capture_emulation import emulate_capture
    from repro_torch.core.program import GRAPH_COUNTS, disable_capture

    emulate_capture(monkeypatch)
    cfg, params = _smoke_state(remat=True, remat_policy="dots")
    batch = {k: torch.as_tensor(v)
             for k, v in _np_batch(cfg.vocab, rows=2, seq=8).items()}
    sgld = SGLD(step_size=1e-4) if mode == "sgld" else None

    def run(eager):
        init_fn, step_fn = tbayes.make_train_step(
            cfg, total_tokens=1e4, mode=mode, sgld=sgld, microbatch=2)
        state = init_fn(_clone(params))
        gen = torch.Generator().manual_seed(5)
        with disable_capture() if eager else contextlib.nullcontext():
            metrics = [step_fn(state, gen, batch)[1] for _ in range(4)]
        return state, metrics

    before = dict(GRAPH_COUNTS)
    got, got_m = run(eager=False)
    assert {k: GRAPH_COUNTS[k] - before[k] for k in before} == {
        "captures": 1, "replays": 3}
    want, want_m = run(eager=True)
    for a, b in zip(*(torch.utils._pytree.tree_leaves(s)
                      for s in (got, want))):
        assert torch.equal(a, b)
    for a, b in zip(got_m, want_m):
        assert all(torch.equal(a[k], b[k]) for k in b)
    assert int(got.step) == 4
