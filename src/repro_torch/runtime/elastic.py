"""Elastic re-mesh planning: rebuild the mesh after host loss/gain, as
``repro.runtime.elastic`` (host-only arithmetic, no framework).

Checkpoints are unsharded (see ``repro_torch.ckpt``), so elasticity
reduces to:
given the SURVIVING device count, pick a new (data, model) mesh shape that
(1) keeps the model axis as close as possible to the old one (tensor-
parallel layouts are tied to weight shapes only through divisibility, so
keeping |model| stable avoids re-tuning), and (2) keeps the global batch
divisible by the data axis. The trainer then rebuilds the mesh, places
the parameters on the new devices, and resumes from the last committed step —
data determinism (batch = f(seed, step)) makes the resume exact.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

__all__ = ["plan_elastic_mesh", "ElasticPlan"]


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    shape: Tuple[int, ...]        # (data, model) or (pod, data, model)
    axis_names: Tuple[str, ...]
    dropped_devices: int          # devices idled because of factorization


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def plan_elastic_mesh(n_devices: int, old_model: int, global_batch: int,
                      prefer_pods: Optional[int] = None) -> ElasticPlan:
    """Choose (data, model) for ``n_devices`` survivors.

    Strategy: among factorizations data*model <= n_devices with
    model a power-of-two-ish divisor candidate, maximise used devices,
    then minimise |model - old_model|, then require global_batch % data
    == 0 (relaxing by allowing smaller data).
    """
    best = None
    for model in sorted(set(_divisors(n_devices) + [old_model])):
        if model > n_devices or model <= 0:
            continue
        data = n_devices // model
        while data > 0 and global_batch % data != 0:
            data -= 1
        if data == 0:
            continue
        used = data * model
        score = (used, -abs(model - old_model), -model)
        if best is None or score > best[0]:
            best = (score, (data, model))
    if best is None:
        raise ValueError(f"no valid mesh for {n_devices} devices")
    data, model = best[1]
    shape: Tuple[int, ...] = (data, model)
    names: Tuple[str, ...] = ("data", "model")
    if prefer_pods and prefer_pods > 1 and data % prefer_pods == 0:
        shape = (prefer_pods, data // prefer_pods, model)
        names = ("pod", "data", "model")
    return ElasticPlan(shape, names, n_devices - data * model)
