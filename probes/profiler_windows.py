#!/usr/bin/env python3
"""How torch.profiler loses a window's device activity on the card, and
whether padding the window's edges with host time stops it.

    python3 probes/profiler_windows.py [--windows N] [--pad SECONDS]

Opens N profiler windows in one process (default 300), each recording a
spin kernel, a synchronize and 10 small kernels, as the kernel tests'
one-kernel-a-call checks do; every other window waits ``--pad`` host
seconds (default 0.02) after the spin and after the kernels. Between
windows the card multiplies 4,096-square matrices for about a quarter of a
second, so that wall time passes as in a long test file. For each window
it reads the kernels the profiler kept and the offset of each kernel's
device start from its launch's host start (a few microseconds when the
profiler carries the device clock onto the host's correctly). The card's
name and power limit come first; the last line is one JSON object: for
padded and unpadded windows, the windows that lost a kernel and the
offsets' range.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=300)
    ap.add_argument("--pad", type=float, default=0.02)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profiler_windows: CUDA is not available", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip(), flush=True)
    x = torch.randn(4, 11, device="cuda")
    a = torch.randn(4096, 4096, device="cuda")
    out = {kind: {"windows": 0, "lost": [], "offset_us": []}
           for kind in ("unpadded", "padded")}
    t0 = time.time()
    for w in range(args.windows):
        pad = args.pad if w % 2 else 0.0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(pad)
            for _ in range(10):
                x.mul_(1.0)
            torch.cuda.synchronize()
            time.sleep(pad)
        events = prof.events()
        launches = sorted((e for e in events if e.name.startswith(
            "cudaLaunchKernel")), key=lambda e: e.time_range.start)
        kernels = sorted((e for e in events
                          if e.device_type.name == "CUDA"),
                         key=lambda e: e.time_range.start)
        kept = sum("spin" not in k.name for k in kernels)
        rec = out["padded" if pad else "unpadded"]
        rec["windows"] += 1
        if kept != 10:
            rec["lost"].append({"window": w, "kernels": kept,
                                "seconds": round(time.time() - t0, 1)})
        if len(launches) == len(kernels):
            rec["offset_us"].append(statistics.median(
                k.time_range.start - l.time_range.start
                for k, l in zip(kernels, launches)))
        for _ in range(100):
            a @ a
        torch.cuda.synchronize()
    for kind, rec in out.items():
        offs = rec.pop("offset_us")
        rec["offset_us_min"] = min(offs) if offs else None
        rec["offset_us_median"] = statistics.median(offs) if offs else None
        rec["offset_us_max"] = max(offs) if offs else None
        rec["windows_offset_below_0"] = sum(o < 0 for o in offs)
        print(f"{kind}: {rec}", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "pad_s": args.pad, "result": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
