"""Two synthetic models of the JAX package that reach the density families
no Table-1 model reaches at scale.

* ``family_mix_8k`` — the 8,192-D separable mix of
  ``benchmarks/leapfrog_bench.py`` (Normal 2,048, Gamma 1,024, Beta 1,024,
  StudentT 2,048, Cauchy 1,024, Uniform 512, LogNormal 512). Under the
  autodiff integrator its fused log-joint launches the std_normal, gamma,
  beta and student_t kernels once per evaluation; it compiles to a
  mixed-opcode separable spec, so ``leapfrog="auto"`` runs the fused
  leapfrog. Step 0.01, the benchmark's.
* ``mixed`` — the model of ``tests/test_kernel_families.py``: Gamma 16, a
  scalar Beta, StudentT 8, a 5-D dense ``MvNormal`` and Normal 4, which
  reaches five ``site_block_sum`` families (mvnormal_prec among them) in
  one evaluation. The JAX test draws its covariance with ``jax.random``;
  here the Cholesky factor comes from a NumPy seed unless one is given.

Neither has a hand-written twin. Both take ``device=`` (``None`` means
CUDA) and return a ``PaperModel``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import model, sample
from repro_torch.dists import (Beta, Cauchy, Gamma, LogNormal, MvNormal,
                               Normal, StudentT, Uniform)
from repro_torch.models.paper_suite import PaperModel

__all__ = ["family_mix_8k", "mixed", "mixed_scale_tril", "build_synthetic",
           "SYNTHETIC_NAMES"]


def family_mix_8k(device=None) -> PaperModel:
    dev = resolve_device(device)

    def full(n, v):
        return torch.full((n,), v, device=dev)

    @model
    def family_mix_8k():
        sample("n", Normal(full(2048, 0.0), 2.0))
        sample("g", Gamma(full(1024, 2.0), 1.5))
        sample("b", Beta(full(1024, 2.0), 3.0))
        sample("t", StudentT(4.0, full(2048, 0.0), 1.0))
        sample("c", Cauchy(full(1024, 0.0), 2.0))
        sample("u", Uniform(full(512, -1.0), 1.0))
        sample("l", LogNormal(full(512, 0.0), 1.0))

    return PaperModel("family_mix_8k", family_mix_8k(), None, step_size=0.01)


def mixed_scale_tril(d: int = 5, seed: int = 0) -> np.ndarray:
    """A float32 Cholesky factor of ``a a^T + I`` with ``a = 0.2 N(0, 1)^(d
    x d)`` drawn from ``np.random.default_rng(seed)``, the JAX test's
    recipe with NumPy's generator."""
    a = 0.2 * np.random.default_rng(seed).normal(size=(d, d))
    return np.linalg.cholesky(a @ a.T + np.eye(d)).astype(np.float32)


def mixed(scale_tril: Optional[np.ndarray] = None, device=None) -> PaperModel:
    dev = resolve_device(device)
    tril = torch.tensor(mixed_scale_tril() if scale_tril is None
                        else np.asarray(scale_tril), device=dev)
    d = tril.shape[-1]
    g_conc = torch.full((16,), 2.0, device=dev)
    t_scale = torch.ones(8, device=dev)
    mv_loc = torch.zeros(d, device=dev)
    n_loc = torch.zeros(4, device=dev)

    @model
    def mixed():
        sample("g", Gamma(g_conc, 1.5))
        sample("b", Beta(2.0, 3.0))
        sample("t", StudentT(4.0, 0.0, t_scale))
        sample("mv", MvNormal(mv_loc, tril))
        sample("n", Normal(n_loc, 2.0))

    return PaperModel("mixed", mixed(), None, step_size=0.1)


_BUILDERS = {"family_mix_8k": family_mix_8k, "mixed": mixed}
SYNTHETIC_NAMES = tuple(_BUILDERS)


def build_synthetic(name: str, device=None) -> PaperModel:
    """``family_mix_8k`` or ``mixed`` on ``device``; an unknown name raises
    ``KeyError``."""
    return _BUILDERS[name](device=device)
