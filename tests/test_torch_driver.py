"""PyTorch port: checkpoints, the runtime helpers and the segmented,
resumable, fault-tolerant chain driver (``repro_torch.ckpt``,
``repro_torch.runtime``, ``repro_torch.infer.driver``).

Against ``repro``: the same sequence of saves, torn saves and keep-N
prunes gives the same committed steps, latest step, meta and manifest
paths in both packages; ``health_from_stats`` on the same stats gives the
same ``ChainHealth`` and report; the host-only runtime helpers answer
``tests/test_substrate.py``'s cases alike.

The driver on ``tests/test_resume.py``'s cases (its ``chain_model``, 80
observations), port against port, since ``repro``'s chains draw from
threefry: the port's contract is stronger than ``repro``'s (whose
segmented run misses its own test, ROADMAP Queue 3 C) — a segmented run
equals the unsegmented ``run_chains`` bit for bit, and an interrupted run
resumed into a cleared program cache equals the uninterrupted one (HMC,
NUTS, RWMH). Captures run through ``tests/_capture_emulation.py``, so the
transitions are recorded and replayed as on the card.
"""
import dataclasses
import json
import os
import signal

import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.infer import driver as jdriver
from repro.runtime import elastic as jelastic
from repro.runtime import straggler as jstraggler
from repro.runtime.faultinject import torn_save as jtorn_save
from repro_torch import model, observe, sample
from repro_torch.ckpt.checkpoint import (AsyncCheckpointer, committed_steps,
                                         latest_step, read_meta, restore,
                                         save)
from repro_torch.core.program import clear_cache, disable_capture
from repro_torch.dists import HalfNormal, Normal
from repro_torch.infer import HMC, NUTS, RWMH, ChainHealth, run_chains
from repro_torch.infer import driver as tdriver
from repro_torch.runtime import (HeartbeatMonitor, NaNInjector,
                                 PreemptionHandler, ScriptedPreemption,
                                 SimulatedKill, StragglerDetector,
                                 plan_elastic_mesh, torn_save)
from _capture_emulation import emulate_capture
from _jax_reference import _reference_compiled_unoptimised  # noqa: F401

DEV = "cpu"


# ---------------------------------------------------------------------------
# checkpoints against repro's
# ---------------------------------------------------------------------------
def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(4, 8)).astype(np.float32),
            "nested": {"b": np.arange(5, dtype=np.int32),
                       "t": (np.float32(seed), [np.ones(2), np.zeros(3)])},
            "scalar": np.float32(3.5)}


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def test_checkpoint_sequence_equals_the_reference(tmp_path):
    """Saves with and without meta, keep-N prunes, and torn saves at both
    kill points, in both packages: the same steps, meta and manifests."""
    out = []
    for pkg, torn, d in ((jckpt, jtorn_save, str(tmp_path / "j")),
                         (None, torn_save, str(tmp_path / "t"))):
        sv = jckpt.save if pkg else save
        cs = jckpt.committed_steps if pkg else committed_steps
        ls = jckpt.latest_step if pkg else latest_step
        rm = jckpt.read_meta if pkg else read_meta
        seen = []
        for s in (1, 2, 3, 4):
            sv(d, s, _tree(s), keep=2, meta={"num_chains": s})
            seen.append((cs(d), ls(d), rm(d)))
        torn(d, 5, _tree(5), kill_at="before_commit")
        torn(d, 6, _tree(6), kill_at="before_rename")
        sv(d, 7, _tree(7))
        seen.append((cs(d), ls(d), rm(d), rm(d, 4), sorted(os.listdir(d))))
        seen.append(_manifest(d, 7))
        out.append(seen)
    assert out[0] == out[1]
    assert out[1][-2][:2] == ([3, 4, 7], 7)  # the last save keeps all


def test_restore_target_roundtrip_and_shape_check(tmp_path):
    d = str(tmp_path / "ck")
    t = {"w": torch.randn(4, 8), "nested": {"b": torch.arange(5)},
         "q": (torch.ones(2, dtype=torch.float64), None)}
    save(d, 10, t)
    step, out = restore(d, target=t)
    assert step == 10 and out["q"][1] is None
    for a, b in ((t["w"], out["w"]), (t["nested"]["b"], out["nested"]["b"]),
                 (t["q"][0], out["q"][0])):
        assert torch.is_tensor(b) and b.dtype == a.dtype and torch.equal(a, b)
    _, flat = restore(d)
    assert sorted(flat) == ["['nested']['b']", "['q'][0]", "['w']"]
    with pytest.raises(ValueError):
        restore(d, target={"w": torch.zeros(3, 3), "nested": {"b": 0},
                           "q": (torch.ones(2), None)})
    ck = AsyncCheckpointer(d, keep=2)
    for s in range(3):
        ck.save(s + 20, {"w": torch.full((2,), float(s))})
    ck.wait()
    assert committed_steps(d) == [21, 22]
    assert float(restore(d, target={"w": torch.zeros(2)})[1]["w"][0]) == 2.0


# ---------------------------------------------------------------------------
# health against repro's
# ---------------------------------------------------------------------------
def _stats(kind):
    rng = np.random.default_rng(3)
    logp = rng.normal(-10.0, 0.5, size=(4, 30)).astype(np.float32)
    acc = rng.uniform(0.5, 1.0, size=(4, 30)).astype(np.float32)
    div = rng.uniform(size=(4, 30)) < 0.05
    if kind == "stuck":
        acc[2] = 0.0
    if kind == "outlier":
        logp[1] -= 500.0
    if kind == "nan":
        logp[3, 7] = np.nan
    if kind == "nodiv":
        return {"logp": logp}
    return {"logp": logp, "accept_prob": acc, "diverging": div}


@pytest.mark.parametrize("kind", ["ok", "stuck", "outlier", "nan", "nodiv"])
def test_health_from_stats_equals_the_reference(kind):
    kw = dict(num_warmup=5, num_samples=30, num_chains=4)
    want = jdriver.health_from_stats(_stats(kind), **kw)
    got = tdriver.health_from_stats(_stats(kind), **kw)
    for f in ("num_chains", "target_warmup", "target_samples", "completed",
              "stuck", "outliers", "fallback_segments", "preempted", "ok"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.divergences, want.divergences)
    np.testing.assert_array_equal(got.nonfinite, want.nonfinite)
    assert got.report() == want.report()


def test_health_report_shape():
    h = ChainHealth(num_chains=2, target_warmup=10, target_samples=20,
                    completed=30, divergences=np.array([1, 0]),
                    nonfinite=np.zeros(2, np.int64))
    assert h.ok
    r = h.report()
    assert "OK" in r and "divergences: 1" in r


# ---------------------------------------------------------------------------
# the host-only runtime helpers (tests/test_substrate.py's cases)
# ---------------------------------------------------------------------------
def test_heartbeat_straggler_and_elastic_plans_equal_the_reference():
    now = [0.0]
    hb = HeartbeatMonitor(4, timeout_s=10.0, clock=lambda: now[0])
    now[0] = 5.0
    for h in (0, 1, 3):
        hb.beat(h)
    now[0] = 12.0
    assert hb.failed_hosts() == [2] and hb.alive_hosts() == [0, 1, 3]
    assert not hb.all_alive()
    rng = np.random.default_rng(0)
    dets = [StragglerDetector(8, patience=3, min_steps=5),
            jstraggler.StragglerDetector(8, patience=3, min_steps=5)]
    for step in range(20):
        times = {h: float(1.0 + 0.05 * rng.random()) for h in range(8)}
        times[5] = 3.0
        if step in (7, 8):
            times[2] = 9.0  # a transient blip
        for det in dets:
            det.record_step(times)
    assert dets[0].stragglers() == dets[1].stragglers() == [5]
    assert dets[0].summary() == dets[1].summary()
    for args in ((16, 4, 64), (12, 4, 64), (13, 4, 32), (32, 4, 64, 2)):
        assert dataclasses.astuple(plan_elastic_mesh(*args)) == \
            dataclasses.astuple(jelastic.plan_elastic_mesh(*args))


def test_preemption_handler_flag_and_context_manager_uninstalls():
    prev = signal.getsignal(signal.SIGTERM)
    with PreemptionHandler() as ph:
        assert signal.getsignal(signal.SIGTERM) == ph._on_signal
        assert not ph.preempted
        ph.trigger()
        assert ph.preempted
    assert signal.getsignal(signal.SIGTERM) == prev
    ph = ScriptedPreemption(after_polls=2)
    assert [ph.preempted for _ in range(4)] == [False, False, True, True]
    assert issubclass(SimulatedKill, BaseException)
    assert not issubclass(SimulatedKill, Exception)
    with pytest.raises(ValueError):
        torn_save("/nonexistent/unused", 0, {"a": np.zeros(1)},
                  kill_at="nowhere")


# ---------------------------------------------------------------------------
# the driver (tests/test_resume.py's cases, port against port)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def chain_model():
    np.random.seed(7)
    y = np.random.normal(2.0, 1.0, size=80).astype(np.float32)

    @model
    def g(y):
        mu = sample("mu", Normal(0.0, 10.0))
        s = sample("s", HalfNormal(2.0))
        observe("y", Normal(mu, s), y)

    return g(torch.tensor(y))


def _same(a, b):
    return (a.names() == b.names() and set(a.stats) == set(b.stats)
            and all(np.array_equal(a[k], b[k]) for k in a.names())
            and all(np.array_equal(a.stats[k], b.stats[k], equal_nan=True)
                    for k in a.stats))


def test_segmented_equals_unsegmented_bit_for_bit(chain_model, monkeypatch):
    emulate_capture(monkeypatch)
    kern = HMC(step_size=0.05, n_leapfrog=4, adapt_step_size=True)
    common = dict(num_samples=40, num_warmup=30, num_chains=3, device=DEV)
    single = run_chains(0, chain_model, kern, **common)
    seg = run_chains(0, chain_model, kern, checkpoint_every=13, **common)
    with disable_capture():
        eager = run_chains(0, chain_model, kern, checkpoint_every=7, **common)
    assert _same(single, seg) and _same(single, eager)
    assert seg.health is not None and seg.health.ok
    assert single.health.ok and single.health.completed == 70


@pytest.mark.parametrize("kern,after", [
    (HMC(step_size=0.05, n_leapfrog=4, adapt_step_size=True), 2),
    (HMC(step_size=0.05, n_leapfrog=4, adapt_step_size=True,
         leapfrog="reference"), 1),
    (NUTS(step_size=0.1, max_depth=4), 2),
    (RWMH(proposal_scale=0.3), 3),
], ids=["hmc", "hmc_autodiff", "nuts", "rwmh"])
def test_interrupt_resume_bit_exact(chain_model, kern, after, tmp_path,
                                    monkeypatch):
    emulate_capture(monkeypatch)
    common = dict(num_samples=24, num_warmup=12, num_chains=2,
                  checkpoint_every=9, device=DEV)
    uninterrupted = run_chains(0, chain_model, kern, **common)

    d = str(tmp_path / "ckpt")
    partial = run_chains(0, chain_model, kern, checkpoint_dir=d,
                         preemption=ScriptedPreemption(after_polls=after),
                         **common)
    assert partial.health.preempted
    assert 0 < partial.health.completed < 36
    assert partial.num_samples == partial.health.completed_samples
    # the preemption checkpoint is committed and resumable
    assert latest_step(d) == partial.health.completed
    assert partial.health.snapshot_bytes > 0

    clear_cache()  # the resume builds every program anew
    resumed = run_chains(0, chain_model, kern, checkpoint_dir=d, **common)
    assert resumed.health.resumed_from == partial.health.completed
    assert _same(uninterrupted, resumed)
    assert latest_step(d) == 36  # warmup + samples


def test_meta_mismatch_refuses_resume(chain_model, tmp_path):
    d = str(tmp_path / "ckpt")
    kern = RWMH(proposal_scale=0.3)
    kw = dict(num_samples=20, checkpoint_dir=d, checkpoint_every=10,
              device=DEV)
    run_chains(0, chain_model, kern, num_chains=2, **kw)
    assert read_meta(d)["seed"] == 0
    for seed, chains in ((1, 2), (0, 3)):
        with pytest.raises(ValueError, match="different run configuration"):
            run_chains(seed, chain_model, kern, num_chains=chains, **kw)
    # a mesh is ported (ROADMAP item 8); what is not one is refused
    with pytest.raises(TypeError, match="mesh must be a ShardedRun"):
        run_chains(0, chain_model, kern, 4, mesh=object(), device=DEV,
                   checkpoint_every=2)


@pytest.mark.parametrize("fallback", [True, False], ids=["fallback", "none"])
def test_nan_injection(chain_model, fallback, monkeypatch):
    """A NaN poisoned into the state on the device at transition 17 (a
    captured transition) is caught by the segment's guard rails; with the
    fallback the segment is rerun on the reference twin and every draw is
    finite, without it the NaN is recorded."""
    emulate_capture(monkeypatch)
    inj = NaNInjector(HMC(step_size=0.05, n_leapfrog=3,
                          adapt_step_size=fallback), at_iterations={17})
    ch = run_chains(0, chain_model, inj, num_samples=30, num_warmup=10,
                    num_chains=2, checkpoint_every=8, fallback=fallback,
                    device=DEV)
    h = ch.health
    assert int(h.nonfinite.sum()) >= 1 and not h.ok
    if fallback:
        assert h.fallback_segments == 1
        assert np.isfinite(ch["mu"]).all()
        assert np.isfinite(ch.stats["logp"]).all()
        assert "fused->reference fallback" in h.report()
    else:
        assert h.fallback_segments == 0
        assert np.isnan(ch.stats["logp"][:, 7:]).all()


def test_scripted_preemption_commits_and_exits_cleanly(chain_model,
                                                       tmp_path):
    d = str(tmp_path / "ckpt")
    ch = run_chains(0, chain_model, RWMH(proposal_scale=0.3), num_samples=40,
                    num_chains=2, checkpoint_dir=d, checkpoint_every=10,
                    preemption=ScriptedPreemption(after_polls=1), device=DEV)
    assert ch.health.preempted
    assert ch.num_samples == ch.health.completed_samples == 20
    # the final checkpoint is SYNCHRONOUS and committed before return
    assert latest_step(d) == ch.health.completed
    assert read_meta(d)["num_samples"] == 40
    assert "PREEMPTED" in ch.health.report()


def test_resume_skips_torn_latest(chain_model, tmp_path):
    """A writer killed mid-save of step N makes resume fall back to the
    previous committed step and still finish the run bit for bit."""
    d = str(tmp_path / "ckpt")
    kern = RWMH(proposal_scale=0.3)
    common = dict(num_samples=30, num_chains=2, checkpoint_every=10,
                  device=DEV)
    uninterrupted = run_chains(5, chain_model, kern, **common)
    run_chains(5, chain_model, kern, checkpoint_dir=d,
               preemption=ScriptedPreemption(after_polls=2), **common)
    good = latest_step(d)
    _, tree = restore(d, good)
    torn_save(d, good + 10, tree, kill_at="before_commit")
    assert latest_step(d) == good
    resumed = run_chains(5, chain_model, kern, checkpoint_dir=d, **common)
    assert resumed.health.resumed_from == good
    assert _same(uninterrupted, resumed)


def test_stuck_chain_guard_rail_and_summary(chain_model):
    ch = run_chains(0, chain_model, HMC(step_size=3.0, n_leapfrog=3),
                    num_samples=30, num_warmup=10, num_chains=2,
                    checkpoint_every=8, device=DEV)
    acc = ch.stats["accept_prob"]
    assert (acc.mean(axis=1) < 1e-3).any()
    assert ch.health.stuck and not ch.health.ok
    assert "stuck chains" in ch.health.report()
    assert ch.stats["diverging"].shape == (2, 30)
    s = ch.summary()
    assert "div" in s.splitlines()[0].split() and "chain health" in s
