#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

Drives the port's main path — the paper's Table-1 loop: typed trace ->
fused flat log-joint -> static HMC with 4 leapfrog steps over 4 chains —
for ``logreg`` (10,000 x 100) and ``naive_bayes`` (1,000 x 40, 10 classes)
at full width, through the hand-written CUDA kernels of
``src/repro_torch/kernels/fused_logpdf/csrc``. Phases, in order:

1. the card: ``torch.cuda.get_device_name`` and ``nvidia-smi``'s name and
   power limit;
2. builds the kernel source with ``nvcc`` and prints the build time;
3. holds each kernel against its plain PyTorch version on the card
   (rtol 1e-6; ragged sizes, 1/4/16 rows, a stride-0 ``y``), checks that
   two runs are bit-identical and that the backward works through
   ``vmap(grad)`` with one launch for the whole chain axis;
4. ``logreg``: ``run_chains(HMC(step_size=0.002, n_leapfrog=4),
   num_chains=4, num_samples=2000)`` with the launch counts set to 0 just
   before and read just after; checks finite draws and logp, the mean
   acceptance, and the fused density at the final draws against the
   per-site reference density and the hand-written twin (rtol 1e-5);
5. the same for ``naive_bayes`` (step 0.01);
6. times each kernel at the main path's shapes beside its bound, its plain
   version and one PyTorch library call (device time from the profiler,
   and the time the host takes to issue each call), and profiles a window
   of ``logreg`` transitions for the device's busy share.

Usage, from the root of a checkout, on a machine with one CUDA GPU:

    python3 chip_smoke.py [--samples 2000] [--out build/chip_smoke.json]

The last two lines of standard output are the kernels' JSON line and
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero and
prints no result, as does a machine without CUDA or a directory without
the port's sources.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# float ops per element, as written in the .cu source
STD_NORMAL_OPS = 4      # two multiplies, a subtract, the add into the sum
BERNOULLI_OPS = 11      # max, fabs, 2 negations, exp, log1p, add, 1-y, mul, sub, sum
KERNEL_SOURCE = "src/repro_torch/kernels/fused_logpdf/csrc/fused_logpdf.cu"
REPLACES = {
    "std_normal_sum": "src/repro/kernels/fused_logpdf/kernel.py:54",
    "bernoulli_logit_sum": "src/repro/kernels/fused_logpdf/kernel.py:97",
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*parts) -> None:
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# phase 1: the card
# ---------------------------------------------------------------------------
def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    check(out, "nvidia-smi printed nothing")
    return out.splitlines()[0].strip()


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
MAIN_SHAPES = {"std_normal_sum": [(4, 101), (4, 400), (4, 40000)],
               "bernoulli_logit_sum": [(4, 10000)]}
CHECK_ROWS = (1, 4, 16)
CHECK_N = (1, 101, 255, 257, 400, 10000, 40000, 40400, 1_000_003)


def check_kernels(torch, ops, ref):
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(1234)
    worst = {k: 0.0 for k in MAIN_SHAPES}
    shapes = sorted({(r, n) for r in CHECK_ROWS for n in CHECK_N}
                    | {s for v in MAIN_SHAPES.values() for s in v})
    for rows, n in shapes:
        z = 2.0 * torch.randn(rows, n, generator=gen, device=dev)
        y = (torch.rand(n, generator=gen, device=dev) < 0.5).float()
        cases = [("std_normal_sum", ops.std_normal_sum_rows, (z,),
                  ref.std_normal_logpdf_sum_ref)]
        for ys in (y.expand(rows, n), y.repeat(rows, 1)):  # stride 0, dense
            cases.append(("bernoulli_logit_sum", ops.bernoulli_logit_sum_rows,
                          (z, ys), ref.bernoulli_logits_logpmf_sum_ref))
        for name, kern, args, plain in cases:
            got = kern(*args)
            again = kern(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            check(torch.equal(got, again),
                  f"{name} {rows}x{n}: two runs differ")
            err = (got - want).abs()
            tol = 1e-6 * want.abs()
            check(bool((err <= tol).all()),
                  f"{name} {rows}x{n}: max rel err "
                  f"{float((err / want.abs()).max()):.3e} > 1e-6")
            if (rows, n) in MAIN_SHAPES[name]:
                worst[name] = max(worst[name], float(err.max()))
    log(f"kernels vs plain: {len(shapes)} shapes x 3 cases, rtol 1e-6, "
        f"bit-identical reruns: ok")

    # backward through vmap(grad): one launch for the whole chain axis
    z = torch.randn(4, 10000, generator=gen, device=dev)
    y = (torch.rand(10000, generator=gen, device=dev) < 0.5).float()
    ops.reset_launch_counts()
    g = torch.func.vmap(torch.func.grad(ops.std_normal_logpdf_sum))(z)
    gl = torch.func.vmap(torch.func.grad(ops.bernoulli_logits_logpmf_sum),
                         in_dims=(0, None))(z, y)
    torch.cuda.synchronize()
    check(ops.LAUNCHES == {"std_normal_sum": 1, "bernoulli_logit_sum": 1},
          f"vmap(grad) over 4 chains launched {ops.LAUNCHES}, expected one "
          "launch per kernel")
    torch.testing.assert_close(g, -z, rtol=1e-6, atol=0)
    torch.testing.assert_close(gl, y - torch.sigmoid(z), rtol=1e-6, atol=1e-7)
    log("vmap(grad) backward: ok, one launch per kernel for 4 chains")
    return worst


# ---------------------------------------------------------------------------
# phases 4-5: the main path
# ---------------------------------------------------------------------------
def run_model(torch, name, num_samples, seed=0):
    import numpy as np

    from repro_torch.infer import HMC, run_chains
    from repro_torch.kernels.fused_logpdf import ops
    from repro_torch.models import build

    pm = build(name, device=DEVICE)
    kernel = HMC(step_size=pm.step_size, n_leapfrog=pm.n_leapfrog)
    num_chains = 4
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    chain = run_chains(seed, pm.model, kernel, num_samples,
                       num_chains=num_chains, device=DEVICE)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)

    evals = num_samples * pm.n_leapfrog + 1  # + the initial gradient
    logp = chain.stats["logp"]
    acc = float(chain.stats["accept_prob"].mean())
    for site in chain.names():
        check(np.isfinite(chain[site]).all(),
              f"{name}: non-finite draws of '{site}'")
    check(np.isfinite(logp).all(), f"{name}: non-finite logp")
    check(0.0 < acc <= 1.0, f"{name}: mean acceptance {acc} not in (0, 1]")

    # the fused density at the final draws vs the per-site reference and
    # the hand-written twin, on the card (all sites are real-valued, so the
    # constrained draws are the unconstrained flat state)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    tvi = pm.model.typed_varinfo(gen).link()
    q = torch.cat([torch.as_tensor(chain[s.name][:, -1]).reshape(num_chains, -1)
                   for s in tvi.layout.sites], dim=1).to(DEVICE)
    fused = torch.func.vmap(pm.model.make_logdensity_fn(tvi))(q)
    refd = torch.func.vmap(pm.model.make_logdensity_fn(
        tvi, backend="reference"))(q)
    hand = torch.func.vmap(pm.handwritten)(q)
    torch.testing.assert_close(fused, refd, rtol=1e-5, atol=0)
    torch.testing.assert_close(fused, hand, rtol=1e-5, atol=0)
    torch.testing.assert_close(fused.cpu(), torch.as_tensor(logp[:, -1]),
                               rtol=1e-5, atol=0)
    rel = float(((fused - refd).abs() / refd.abs()).max())

    summary = chain.summary().splitlines()
    result = {
        "model": name, "num_chains": num_chains, "num_samples": num_samples,
        "step_size": pm.step_size, "n_leapfrog": pm.n_leapfrog,
        "seconds": secs, "seconds_per_draw": secs / num_samples,
        "grad_evals_per_s": num_chains * evals / secs,
        "launches": launches, "evals_per_chain": evals,
        "mean_accept": acc, "fused_vs_reference_max_rel": rel,
        "summary_head": summary[:4],
    }
    log(f"{name}: {num_chains} chains x {num_samples} draws in {secs:.2f} s: "
        f"{secs / num_samples * 1e3:.3f} ms/draw, "
        f"{result['grad_evals_per_s']:.0f} grad evals/s, mean accept "
        f"{acc:.3f}, launches {launches}, fused vs reference max rel "
        f"{rel:.2e}")
    for line in summary[:4]:
        log("   ", line)
    return result, pm, kernel


# ---------------------------------------------------------------------------
# phase 6: timing
# ---------------------------------------------------------------------------
def time_ms(torch, fn, iters=200, warmup=20):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(event) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def device_ms(torch, fn, iters=50):
    """Device time per call of every CUDA kernel that ``fn`` launches, from
    torch.profiler; None when the trace shows none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(device_us(e) for e in prof.key_averages()
                if e.device_type.name == "CUDA")
    return total / 1e3 / iters if total > 0 else None


def time_kernels(torch, F, ops, ref):
    """Each kernel at the main path's shapes beside its plain version and
    one library call: device time from the profiler (``*_ms``) and
    CUDA-event time over back-to-back calls from the host
    (``*_issued_ms``, the wrapper's host cost at these sizes)."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for name, shapes in MAIN_SHAPES.items():
        for r, n in shapes:
            z = torch.randn(r, n, generator=gen, device=dev)
            if name == "std_normal_sum":
                args = (z,)
                kern, plain = ops.std_normal_sum_rows, ref.std_normal_logpdf_sum_ref
                zeros, ones = torch.zeros_like(z), torch.ones_like(z)

                def library(z=z, zeros=zeros, ones=ones):
                    return F.gaussian_nll_loss(z, zeros, ones, full=True,
                                               reduction="none").sum(-1)

                nbytes = 4 * r * n + 4 * r
                nops = STD_NORMAL_OPS * r * n
            else:
                y = (torch.rand(n, generator=gen, device=dev) < 0.5).float()
                ys = y.expand(r, n)  # stride 0, as on the main path
                args = (z, ys)
                kern = ops.bernoulli_logit_sum_rows
                plain = ref.bernoulli_logits_logpmf_sum_ref

                def library(z=z, ys=ys):
                    return F.binary_cross_entropy_with_logits(
                        z, ys, reduction="none").sum(-1)

                nbytes = 4 * r * n + 4 * n + 4 * r  # y read once
                nops = BERNOULLI_OPS * r * n
            # the library call computes the negated sum: hold it to the kernel
            torch.testing.assert_close(-library(), kern(*args),
                                       rtol=1e-5, atol=0)
            calls = {"": lambda: kern(*args), "plain_": lambda: plain(*args),
                     "library_": library}
            row = {"name": name, "shape": [r, n],
                   "ms_from": "torch.profiler device time"}
            # plain, kernel, kernel, plain: compare within one call
            for prefix in ("plain_", "", "", "plain_"):
                row.setdefault(f"{prefix}issued_ms_runs", []).append(
                    time_ms(torch, calls[prefix]))
            row["library_issued_ms_runs"] = [time_ms(torch, library)]
            for prefix, fn in calls.items():
                row[f"{prefix}issued_ms"] = min(row[f"{prefix}issued_ms_runs"])
                row[f"{prefix}ms"] = device_ms(torch, fn)
                if row[f"{prefix}ms"] is None:  # the trace shows no device time
                    row[f"{prefix}ms"] = row[f"{prefix}issued_ms"]
                    row["ms_from"] = "cuda events (no device time traced)"
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = nops / FP32_FLOPS_PER_S * 1e3
            row.update(bytes=nbytes, ops=nops, bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations")
            rows.append(row)

            log(f"time {name} {r}x{n} ({row['ms_from']} / issued from the "
                "host), us: " + ", ".join(
                    f"{what} {row[f'{k}ms'] * 1e3:.2f} / "
                    f"{row[f'{k}issued_ms'] * 1e3:.2f}" for what, k in
                    (("kernel", ""), ("plain", "plain_"),
                     ("library", "library_")))
                + f", bound {row['bound_ms'] * 1e3:.4f} ({row['bound_by']})")
    return rows


def profile_transitions(torch, pm, kernel, steps=20):
    """Device busy share and top kernels over ``steps`` logreg transitions."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=DEVICE).manual_seed(3)
    tvi = pm.model.typed_varinfo(gen).link()
    kern = kernel.make_kernel(pm.model.make_logdensity_fn(tvi), tvi.num_flat)
    state = kern.init(tvi.flat().expand(4, tvi.num_flat).contiguous())
    for _ in range(5):
        state, _ = kern.step(state, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = kern.step(state, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [(e.key, device_us(e), e.count) for e in events
               if device_us(e) > 0 and e.device_type.name == "CUDA"]
    busy_us = sum(k[1] for k in kernels)
    kernels.sort(key=lambda k: -k[1])
    host = sorted((e for e in events if e.device_type.name == "CPU"),
                  key=lambda e: -e.self_cpu_time_total)
    syncs = sum(e.count for e in events
                if "Synchronize" in e.key or "Memcpy" in e.key)
    out = {"model": pm.name, "transitions": steps,
           "wall_ms_per_transition": wall * 1e3 / steps,
           "device_ms_per_transition": busy_us / 1e3 / steps,
           "busy_share": busy_us / 1e6 / wall if busy_us else None,
           "kernel_launches_per_transition": sum(k[2] for k in kernels) / steps,
           "syncs_or_copies_per_transition": syncs / steps,
           "top_kernels": [{"name": k, "device_us": us, "count": c}
                           for k, us, c in kernels[:12]],
           "top_host_ops": [{"name": e.key, "self_cpu_us": e.self_cpu_time_total,
                             "count": e.count} for e in host[:12]]}
    if busy_us:
        log(f"profile {pm.name}: {out['wall_ms_per_transition']:.3f} ms wall "
            f"per transition, {out['device_ms_per_transition']:.3f} ms on the "
            f"device, busy share {out['busy_share']:.3f}")
        log(f"    {out['kernel_launches_per_transition']:.0f} kernel launches "
            f"and {out['syncs_or_copies_per_transition']:.1f} syncs or copies "
            "per transition; top kernels by device time:")
        for k in out["top_kernels"]:
            log(f"    {k['device_us'] / steps:9.2f} us/transition "
                f"x{k['count'] // steps:<4d} {k['name'][:90]}")
        log("    top host ops by self CPU time:")
        for h in out["top_host_ops"]:
            log(f"    {h['self_cpu_us'] / steps:9.2f} us/transition "
                f"x{h['count'] // steps:<4d} {h['name'][:90]}")
    else:
        log("profile: the trace shows no device time (not measured)")
    return out


# ---------------------------------------------------------------------------
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--samples", type=int, default=2000,
                    help="HMC draws per chain for each model (Table 1: 2000)")
    ap.add_argument("--out", default=str(ROOT / "build" / "chip_smoke.json"),
                    help="where to write the full results as JSON")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels.fused_logpdf import ops, ref
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port from {ROOT / 'src'}: {exc}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 1
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"device: {kind} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    log(smi)

    # phase 2
    t0 = time.perf_counter()
    ops._lib()
    build_s = time.perf_counter() - t0
    log(f"built and loaded {ops.kernel_source().relative_to(ROOT)} in "
        f"{build_s:.2f} s")

    # phase 3
    worst = check_kernels(torch, ops, ref)

    # phases 4-5: the main path, counts zeroed just before each model
    runs = {}
    for name in ("logreg", "naive_bayes"):
        runs[name], pm, kernel = run_model(torch, name, args.samples)
        if name == "logreg":
            logreg_pm, logreg_kernel = pm, kernel
    per_eval = {"logreg": {"std_normal_sum": 1, "bernoulli_logit_sum": 1},
                "naive_bayes": {"std_normal_sum": 2, "bernoulli_logit_sum": 0}}
    for name, run in runs.items():
        for k, per in per_eval[name].items():
            want = per * run["evals_per_chain"]
            check(run["launches"][k] == want,
                  f"{name}: {k} launched {run['launches'][k]} times, "
                  f"expected {want} (one per density family block per "
                  "evaluation, all chains in one launch)")
        check(sum(run["launches"].values()) > 0, f"{name}: no kernel launched")
    check(runs["logreg"]["launches"]["bernoulli_logit_sum"] > 0
          and runs["logreg"]["launches"]["std_normal_sum"] > 0,
          "logreg did not launch both kernels")

    # phase 6
    timings = time_kernels(torch, F, ops, ref)
    prof = profile_transitions(torch, logreg_pm, logreg_kernel)

    kernels = []
    for name in MAIN_SHAPES:
        main = max((t for t in timings if t["name"] == name),
                   key=lambda t: t["bytes"])
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name],
            "launches": sum(r["launches"][name] for r in runs.values()),
            "max_abs_err": worst[name], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "issued_ms": main["issued_ms"],
            "plain_issued_ms": main["plain_issued_ms"],
            "library_issued_ms": main["library_issued_ms"],
            "ms_from": main["ms_from"], "shape": main["shape"],
        })
    result = {"device": kind, "nvidia_smi": smi, "build_s": build_s,
              "runs": runs, "timings": timings, "profile": prof,
              "kernels": kernels}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    log(f"wrote {out}")

    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
