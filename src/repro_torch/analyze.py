"""CLI front-end for the model static analyser.

Usage::

    python -m repro_torch.analyze                 # whole paper suite
    python -m repro_torch.analyze --models gauss_unknown,eight_schools
    python -m repro_torch.analyze --files my_models.py
    python -m repro_torch.analyze --json report.json   # archive JSON too
    python -m repro_torch.analyze --device cpu    # the suite's data on the CPU

The paper suite's data live on ``--device`` (default: the card, as every
entry point of the port); a file's models keep the devices it gave them.

Exit status: 0 when no error-severity finding fired on any analysed
model, 1 otherwise (warnings never fail the run) — so CI can gate on it
directly, ruff-style. ``--json`` writes the same schema the benchmark
reports use (validated by ``validate_analysis_report`` before writing).
"""
from __future__ import annotations

import argparse
import importlib.util
import sys
from typing import List, Tuple


def _suite_models(names=None, device=None) -> List[Tuple[str, object]]:
    from repro_torch.models import paper_suite
    if names is None:
        names = tuple(paper_suite.MODEL_NAMES) + ("eight_schools",)
    return [(n, paper_suite.build(n, device=device).model) for n in names]


def _suite_generator(device):
    """The discovery draws of the suite's models, seed 0 on ``device``
    (some keep their tensors in the model's closure, not its data)."""
    import torch

    from repro_torch._device import resolve_device
    return torch.Generator(device=resolve_device(device)).manual_seed(0)


def discover_models(path: str) -> Tuple[List[Tuple[str, object]], List[str]]:
    """Import a python file, return its analysable models + skip notes.

    Collects module-level bound ``Model`` instances directly, and binds
    ``@model`` generators whose parameters all carry defaults; a
    generator that needs data it doesn't default is skipped with a note
    rather than guessed at.
    """
    import inspect

    from repro_torch.core.model import Model, ModelGen

    spec = importlib.util.spec_from_file_location(
        f"_repro_torch_analyze_{abs(hash(path))}", path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot import {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    found: List[Tuple[str, object]] = []
    notes: List[str] = []
    for attr, obj in sorted(vars(mod).items()):
        if attr.startswith("_"):
            continue
        if isinstance(obj, Model):
            found.append((f"{path}::{attr}", obj))
        elif isinstance(obj, ModelGen):
            params = obj.signature.parameters.values()
            if all(p.default is not inspect.Parameter.empty for p in params):
                found.append((f"{path}::{attr}", obj()))
            else:
                notes.append(f"{path}::{attr}: skipped (generator needs "
                             "data arguments; bind it to analyse)")
    if not found:
        notes.append(f"{path}: no module-level models found")
    return found, notes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analyze",
        description="Static analysis: model graph, lints, fusion coverage.")
    ap.add_argument("--models", default=None,
                    help="comma-separated paper-suite model names "
                         "(default: the whole suite)")
    ap.add_argument("--files", nargs="*", default=[],
                    help="python files to import and scan for models")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the JSON analysis report here")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-site tables; print verdict lines only")
    ap.add_argument("--device", default=None,
                    help="device of the paper suite's data (default: cuda)")
    args = ap.parse_args(argv)

    from repro_torch.analysis import (analyze_model, build_analysis_report,
                                      write_analysis_report)

    targets: List[Tuple[str, object]] = []
    notes: List[str] = []
    suite: List[Tuple[str, object]] = []
    if args.files:
        for path in args.files:
            found, n = discover_models(path)
            targets.extend(found)
            notes.extend(n)
        if args.models:
            names = tuple(args.models.split(","))
            suite = _suite_models(names, args.device)
    else:
        names = tuple(args.models.split(",")) if args.models else None
        suite = _suite_models(names, args.device)
    targets.extend(suite)

    analyses = []
    for label, m in targets:
        # a file's models draw on their data's device, the suite's on --device
        a = analyze_model(m, generator=_suite_generator(args.device)
                          if (label, m) in suite else None)
        a.coverage.model = label  # report under the suite/CLI label
        analyses.append(a)
        if args.quiet:
            status = "ok" if a.ok else f"{len(a.errors())} error(s)"
            print(f"{label}: {status}, {len(a.warnings())} warning(s)")
        else:
            print(a.render())
            print()
    for note in notes:
        print(f"note: {note}", file=sys.stderr)

    if args.json:
        write_analysis_report(args.json, build_analysis_report(analyses))
        print(f"wrote {args.json}", file=sys.stderr)

    n_err = sum(len(a.errors()) for a in analyses)
    n_warn = sum(len(a.warnings()) for a in analyses)
    print(f"{len(analyses)} model(s) analysed: "
          f"{n_err} error(s), {n_warn} warning(s)")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
