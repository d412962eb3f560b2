#!/usr/bin/env python3
"""Device memory that run_chains' cached programs hold after a run.

    python3 probes/transition_memory.py CHECKOUT

In the checkout given (its ``src`` first on the path, so a parent commit
unpacked beside this one can be measured in turns with it): gaussian_10k
(4 chains) at 2,000 draws, then 500, then 2,000 again, on one model (one
cached ``TransitionPrograms``), then logreg with 100 warmup draws (warm
and step captured). The card's name and power limit come first; after
each run one JSON line: the caching allocator's reserved MiB before and
after ``empty_cache()`` (what tensors and graph pools still hold), the
allocated MiB and the peak since the previous line.
"""
import json
import subprocess
import sys
from pathlib import Path

MIB = 1 << 20


def main() -> int:
    root = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        print("transition_memory: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.infer import HMC, run_chains
    from repro_torch.models import build
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip(), flush=True)

    def mem(label):
        torch.cuda.synchronize()
        reserved = torch.cuda.memory_reserved() / MIB
        torch.cuda.empty_cache()
        print(json.dumps({
            "tree": root.name, "after": label,
            "reserved_mib": round(reserved, 1),
            "reserved_after_empty_cache_mib":
                round(torch.cuda.memory_reserved() / MIB, 1),
            "allocated_mib": round(torch.cuda.memory_allocated() / MIB, 1),
            "max_allocated_mib":
                round(torch.cuda.max_memory_allocated() / MIB, 1)}),
              flush=True)
        torch.cuda.reset_peak_memory_stats()

    pm = build("gaussian_10k", device="cuda")
    kernel = HMC(step_size=pm.step_size)
    for n in (2000, 500, 2000):
        run_chains(0, pm.model, kernel, n, num_chains=4, device="cuda")
        mem(f"gaussian_10k {n} draws")
    lm = build("logreg", device="cuda")
    run_chains(0, lm.model, HMC(step_size=lm.step_size, adapt_step_size=True),
               300, num_warmup=100, num_chains=4, device="cuda")
    mem("logreg 100 + 300 draws")
    return 0


if __name__ == "__main__":
    sys.exit(main())
