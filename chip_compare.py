#!/usr/bin/env python3
"""Compare this checkout of the port with another one on one GPU, in one
call, in turns (other, this, this, other): the way to hold a change
against its parent commit (unpacked with ``git archive`` into a directory
that ``.gitignore`` lists) or against a variant of itself, since two calls
may land on hosts of different speed.

    python3 chip_compare.py --other DIR wrappers [--kernels NAME ...]
    python3 chip_compare.py --other DIR leapfrog [--models NAME ...]
    python3 chip_compare.py --other DIR paths [--models NAME ...] [--draws N]

``wrappers`` loads the other checkout's ``fused_logpdf/ops.py`` in this
process under another module name (its kernel source builds into its own
``build/``), holds each wrapper to the other's at rtol 1e-5 (two float32
sums of up to 10^6 terms in different orders), then times
both at ``chip_smoke.MAIN_SHAPES`` (and 1 x 1,000,003 for the one-launch
reductions; beta's and student_t's family_mix_8k blocks again with one
parameter value a row, element stride 0): the time the host takes to
issue a call (CUDA events over back-to-back calls, eight turns), the same
for the per-array function under ``vmap`` over the rows as the main paths
call it (the wrapper plus the ``autograd.Function``'s forward and vmap
rule), and the device time from the profiler (four turns, every kernel a
call launches); ``--kernels categorical_logits_sum`` times the
categorical at ``MAIN_SHAPES``'s two LM vocabularies over 8,192 items
(mamba2's 50,280 classes and 49,152). ``leapfrog`` loads the other
checkout's
``fused_leapfrog/ops.py`` the same way and times both ``fused_leapfrog``s
on the compiled specs of gaussian_10k (uniform NORMAL, 4 x 10,000) and
family_mix_8k (a mixed table, 4 x 8,192), 4 chains and 4 steps, in the
same turns, after holding q, p and the gradient to each other at rtol
1e-5 plus 1e-5 * max|other| and the potential at rtol 1e-5. ``paths`` runs
``chip_smoke.run_model`` for each model in a fresh process per checkout,
four turns, and reads milliseconds per draw. The card's name and power
limit come first; the last line is one JSON object with every number.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TURNS = ("other", "this", "this", "other")
ONE_LAUNCH = ("std_normal_sum", "gamma_unnorm_sum", "beta_unnorm_sum",
              "student_t_unnorm_sum", "normal_sum", "bernoulli_logit_sum")
WIDE = {name: [(1, 1_000_003)] for name in ONE_LAUNCH}
# family_mix_8k's blocks with one parameter value a row (a per-chain scalar
# under vmap); MAIN_SHAPES's cases pass the parameters as one shared row,
# as the main paths do on the card; gauss_unknown's switch route, whose
# data x is shared by the chains and whose mu and sigma are one a chain
SCALAR = {"beta_unnorm_sum": [(4, 1024)], "student_t_unnorm_sum": [(4, 2048)],
          "normal_sum": [(4, 10000)]}
# each wrapper's per-array function, as the fused evaluator calls it
ENTRY = {"std_normal_sum": "std_normal_logpdf_sum",
         "gamma_unnorm_sum": "gamma_unnorm_logpdf_sum",
         "beta_unnorm_sum": "beta_unnorm_logpdf_sum",
         "student_t_unnorm_sum": "student_t_unnorm_logpdf_sum",
         "normal_sum": "normal_logpdf_sum",
         "bernoulli_logit_sum": "bernoulli_logits_logpmf_sum"}
PATHS = ("logreg", "hier_poisson", "gauss_unknown", "sto_volatility", "mixed")
LEAPFROG_PATHS = ("gaussian_10k", "family_mix_8k")


def load_other_ops(other: Path, kernel: str = "fused_logpdf"):
    spec = importlib.util.spec_from_file_location(
        f"other_{kernel}_ops",
        other / f"src/repro_torch/kernels/{kernel}/ops.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def per_row_scalar(t):
    """``t (B, n)`` as one value a row: its first column, at element
    stride 0."""
    return t[:, :1].contiguous().expand_as(t)


def vmapped(torch, fn, args):
    """``fn`` under ``vmap`` over the rows, as the fused evaluator calls
    it: a shared row (row stride 0) unbatched, one value a row as a
    per-chain scalar, anything else batched."""
    ins, dims = [], []
    for t in args:
        if t.shape[0] > 1 and t.stride(0) == 0:
            ins.append(t[0])
            dims.append(None)
        else:
            ins.append(t[:, 0] if t.shape[1] > 1 and t.stride(1) == 0 else t)
            dims.append(0)
    return lambda: torch.func.vmap(fn, in_dims=tuple(dims))(*ins)


def wrappers(torch, cs, other: Path, kernels) -> dict:
    from repro_torch.kernels.fused_logpdf import ops, ref
    mods = {"this": ops, "other": load_other_ops(other)}
    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    for name in kernels:
        cases = ([(shape, False) for shape in
                  cs.MAIN_SHAPES[name] + WIDE.get(name, [])]
                 + [(shape, True) for shape in SCALAR.get(name, [])])
        for shape, scalar in cases:
            args, kern, _, _, _, _ = cs.logpdf_case(
                torch, torch.nn.functional, ops, ref, name, shape, gen)
            if scalar:
                args = args[:1] + tuple(per_row_scalar(t) for t in args[1:])
            fns = {who: (lambda f=getattr(m, kern.__name__): f(*args))
                   for who, m in mods.items()}
            torch.testing.assert_close(fns["this"](), fns["other"](),
                                       rtol=1e-5, atol=0)
            row = {"issued_us": {"this": [], "other": []},
                   "device_us": {"this": [], "other": []}}
            if name in ENTRY and len(shape) == 2:
                entries = {who: vmapped(torch, getattr(m, ENTRY[name]), args)
                           for who, m in mods.items()}
                torch.testing.assert_close(entries["this"](),
                                           entries["other"](), rtol=1e-5,
                                           atol=0)
                row["entry_issued_us"] = {"this": [], "other": []}
            for who in TURNS + TURNS:
                row["issued_us"][who].append(
                    cs.time_ms(torch, fns[who]) * 1e3)
                if "entry_issued_us" in row:
                    row["entry_issued_us"][who].append(
                        cs.time_ms(torch, entries[who]) * 1e3)
            for who in TURNS:
                ms = cs.device_ms(torch, fns[who])
                row["device_us"][who].append(None if ms is None else ms * 1e3)
            key = (f"{name} {'x'.join(map(str, shape))}"
                   f"{' one parameter value a row' if scalar else ''}")
            out[key] = row
            iss, dev = row["issued_us"], row["device_us"]
            ent = row.get("entry_issued_us")
            cs.log(f"{key}: issued us other {iss['other']}, this "
                   f"{iss['this']}; device us other {dev['other']}, this "
                   f"{dev['this']}"
                   + (f"; under vmap issued us other {ent['other']}, this "
                      f"{ent['this']}" if ent else ""))
    return out


def timed_turns(torch, cs, fns) -> dict:
    """Issued time (eight turns) and device time (four turns) of each of
    ``fns`` ("this", "other"), in microseconds."""
    row = {"issued_us": {"this": [], "other": []},
           "device_us": {"this": [], "other": []}}
    for who in TURNS + TURNS:
        row["issued_us"][who].append(cs.time_ms(torch, fns[who]) * 1e3)
    for who in TURNS:
        ms = cs.device_ms(torch, fns[who])
        row["device_us"][who].append(None if ms is None else ms * 1e3)
    return row


def leapfrog(torch, cs, other: Path, models) -> dict:
    """Both checkouts' fused_leapfrog on each path's compiled spec, 4
    chains, 4 steps, in turns."""
    from repro_torch.core.potential import compile_potential
    from repro_torch.kernels.fused_leapfrog import ops as lf_ops
    mods = {"this": lf_ops, "other": load_other_ops(other, "fused_leapfrog")}
    gen = torch.Generator(device="cuda").manual_seed(8)
    out = {}
    for path in models:
        pm = cs.build_model(path)
        spec = compile_potential(pm.model, pm.model.typed_varinfo(
            torch.Generator(device="cuda").manual_seed(0)).link()).spec
        cs.check(spec is not None, f"{path} compiled no separable spec")
        rows, dim = 4, spec.dim
        q = torch.randn(rows, dim, generator=gen, device="cuda")
        p = torch.randn(rows, dim, generator=gen, device="cuda")
        eps = torch.full((rows,), pm.step_size, device="cuda")
        _, g = lf_ops.potential_value_and_grad(spec, q)
        fns = {who: (lambda m=m: m.fused_leapfrog(spec, q, p, g, eps, 4))
               for who, m in mods.items()}
        got, want = fns["this"](), fns["other"]()
        for i in (0, 1, 3):
            torch.testing.assert_close(
                got[i], want[i], rtol=1e-5,
                atol=1e-5 * float(want[i].abs().max()))
        torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
        key = f"fused_leapfrog {path} {rows}x{dim}x4"
        row = out[key] = timed_turns(torch, cs, fns)
        cs.log(f"{key}: issued us other {row['issued_us']['other']}, this "
               f"{row['issued_us']['this']}; device us other "
               f"{row['device_us']['other']}, this "
               f"{row['device_us']['this']}")
    return out


def path_worker(tree: Path, models, draws: int) -> None:
    """One checkout's main paths, in a process of its own."""
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.fused_leapfrog import ops as lf_ops
    from repro_torch.kernels.fused_logpdf import ops
    cs.check(Path(cs.__file__).resolve().parent == tree.resolve(),
             f"imported {cs.__file__}, not {tree}'s chip_smoke.py")
    cs.build_all({cs.LOGPDF_CU: ops._lib, cs.MVN_CU: ops._mvn_lib,
                  cs.LEAPFROG_CU: lf_ops._lib})
    ms = {m: cs.run_model(torch, m, draws)[0]["seconds_per_draw"] * 1e3
          for m in models}
    print(json.dumps(ms), flush=True)


def paths(cs, other: Path, models, draws: int) -> dict:
    out = {m: {"this": [], "other": []} for m in models}
    for who in TURNS:
        tree = ROOT if who == "this" else other
        proc = subprocess.run(
            [sys.executable, str(ROOT / "chip_compare.py"), "--other",
             str(other), "_path_worker", str(tree), "--draws", str(draws),
             "--models", *models],
            capture_output=True, text=True, timeout=1800)
        cs.check(proc.returncode == 0, f"{who} paths failed:\n"
                 f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
        for m, v in json.loads(proc.stdout.strip().splitlines()[-1]).items():
            out[m][who].append(v)
        cs.log(f"paths {who} ({tree}): ms per draw "
               f"{ {m: out[m][who][-1] for m in models} }")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the other checkout")
    ap.add_argument("mode", choices=("wrappers", "leapfrog", "paths",
                                     "_path_worker"))
    ap.add_argument("tree", nargs="?", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--kernels", nargs="+", default=list(ONE_LAUNCH),
                    help="fused_logpdf kernels (chip_smoke.MAIN_SHAPES's "
                         "names)")
    ap.add_argument("--models", nargs="+", default=None,
                    help="paths: chip_smoke models (default PATHS); "
                         "leapfrog: the separable ones (default "
                         "LEAPFROG_PATHS)")
    ap.add_argument("--draws", type=int, default=200)
    args = ap.parse_args()
    if args.mode == "_path_worker":
        path_worker(args.tree, args.models, args.draws)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_compare: CUDA is not available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    smi = cs.nvidia_smi()
    cs.log(smi)
    if args.mode == "wrappers":
        result = wrappers(torch, cs, args.other, args.kernels)
    elif args.mode == "leapfrog":
        result = leapfrog(torch, cs, args.other,
                          args.models or list(LEAPFROG_PATHS))
    else:
        result = paths(cs, args.other, args.models or list(PATHS),
                       args.draws)
    print(json.dumps({"device": smi, "other": str(args.other),
                      "mode": args.mode, "result": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
