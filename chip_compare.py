#!/usr/bin/env python3
"""Compare this checkout of the port with another one on one GPU, in one
call, in turns (other, this, this, other): the way to hold a change
against its parent commit (unpacked with ``git archive`` into a directory
that ``.gitignore`` lists) or against a variant of itself, since two calls
may land on hosts of different speed.

    python3 chip_compare.py --other DIR wrappers [--kernels NAME ...]
    python3 chip_compare.py --other DIR paths [--models NAME ...] [--draws N]

``wrappers`` loads the other checkout's ``fused_logpdf/ops.py`` in this
process under another module name (its kernel source builds into its own
``build/``), holds each wrapper to the other's at rtol 1e-5 (two float32
sums of up to 10^6 terms in different orders), then times
both at ``chip_smoke.MAIN_SHAPES`` (and 1 x 1,000,003 for the one-launch
reductions): the time the host takes to issue a call (CUDA events over
back-to-back calls, eight turns) and the device time from the profiler
(four turns, every kernel a call launches). ``paths`` runs
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
WIDE = {"std_normal_sum": [(1, 1_000_003)],
        "gamma_unnorm_sum": [(1, 1_000_003)]}
PATHS = ("logreg", "hier_poisson", "gauss_unknown", "sto_volatility", "mixed")


def load_other_ops(other: Path):
    spec = importlib.util.spec_from_file_location(
        "other_fused_logpdf_ops",
        other / "src/repro_torch/kernels/fused_logpdf/ops.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def wrappers(torch, cs, other: Path, kernels) -> dict:
    from repro_torch.kernels.fused_logpdf import ops, ref
    mods = {"this": ops, "other": load_other_ops(other)}
    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    for name in kernels:
        for shape in cs.MAIN_SHAPES[name] + WIDE.get(name, []):
            args, kern, _, _, _, _ = cs.logpdf_case(
                torch, torch.nn.functional, ops, ref, name, shape, gen)
            fns = {who: (lambda f=getattr(m, kern.__name__): f(*args))
                   for who, m in mods.items()}
            torch.testing.assert_close(fns["this"](), fns["other"](),
                                       rtol=1e-5, atol=0)
            row = {"issued_us": {"this": [], "other": []},
                   "device_us": {"this": [], "other": []}}
            for who in TURNS + TURNS:
                row["issued_us"][who].append(
                    cs.time_ms(torch, fns[who]) * 1e3)
            for who in TURNS:
                ms = cs.device_ms(torch, fns[who])
                row["device_us"][who].append(None if ms is None else ms * 1e3)
            key = f"{name} {'x'.join(map(str, shape))}"
            out[key] = row
            iss, dev = row["issued_us"], row["device_us"]
            cs.log(f"{key}: issued us other {iss['other']}, this "
                   f"{iss['this']}; device us other {dev['other']}, this "
                   f"{dev['this']}")
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
    ap.add_argument("mode", choices=("wrappers", "paths", "_path_worker"))
    ap.add_argument("tree", nargs="?", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--kernels", nargs="+",
                    default=["std_normal_sum", "gamma_unnorm_sum"])
    ap.add_argument("--models", nargs="+", default=list(PATHS))
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
    else:
        result = paths(cs, args.other, args.models, args.draws)
    print(json.dumps({"device": smi, "other": str(args.other),
                      "mode": args.mode, "result": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
