#!/usr/bin/env python3
"""Whether chip_smoke.py's ``table1_profile`` (torch.profiler windows and
a cProfile run over logreg's gradient evaluations) changes the profiler
windows that phase 7 times kernels with.

    python3 probes/profiler_windows_after_profile.py

Times ``std_normal_sum`` at 4 x 11 as ``chip_smoke.device_ms`` does (50
calls a window, one launch a call expected) before and after one call of
``table1_profile``, and prints each window's kernel events (name, count,
device us). The card's name and power limit come first; the last line is
one JSON object: ``device_ms`` before and after (None: no window whole).
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402


def windows(label, fn, iters=50, attempts=3):
    fn()
    torch.cuda.synchronize()
    for a in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(cs.WINDOW_PAD_S)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(cs.WINDOW_PAD_S)
        events = [(e.key[:60], e.count, round(cs.device_us(e), 1))
                  for e in prof.key_averages()
                  if e.device_type.name == "CUDA" and cs.device_us(e) > 0]
        print(label, "window", a, events, flush=True)
    return cs.device_ms(torch, fn, launches_per_call=1)


def main() -> int:
    from repro_torch.kernels.fused_leapfrog import ops as lf_ops
    from repro_torch.kernels.fused_logpdf import ops
    cs.build_all({cs.LOGPDF_CU: ops._lib, cs.LEAPFROG_CU: lf_ops._lib})
    print(cs.nvidia_smi(), flush=True)
    z = torch.randn(4, 11, device="cuda")
    fn = lambda: ops.std_normal_sum_rows(z)  # noqa: E731
    before = windows("before", fn)
    cs.table1_profile(torch, np)
    after = windows("after", fn)
    print(json.dumps({"device_ms_before": before, "device_ms_after": after}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
