"""The paper's Table-1 models ported so far, with hand-written analogues.

Each constructor returns a ``PaperModel`` with:
* ``model``        — the DSL version (typed-trace path),
* ``handwritten``  — a hand-coded log-density over the SAME flat
  unconstrained layout (the Stan analogue),
* deterministic synthetic data at the paper's stated sizes, drawn by the
  same ``np.random.default_rng(seed)`` calls as the JAX package's
  constructors, so the data are equal bit for bit,
* the static-HMC settings (4 leapfrog steps; per-model step sizes).

Ported so far (the rest are listed in ROADMAP.md):
  gaussian_10k   : 10,000-D standard normal (separable: fused integrator)
  naive_bayes    : 1,000 obs of MNIST->PCA-40 (synthetic stand-in), 10 classes
  logreg         : 10,000 obs x 100 dims

Every constructor takes ``device=`` (``None`` means CUDA) and puts the data
there; the model's tensors never leave it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.core import model, observe, sample
from repro_torch.dists import BernoulliLogits, MvNormalDiag, Normal

__all__ = ["PaperModel", "build", "MODEL_NAMES"]

_LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass
class PaperModel:
    name: str
    model: object                     # bound Model (DSL/typed path)
    handwritten: Optional[Callable]   # flat unconstrained -> log density
    step_size: float
    n_leapfrog: int = 4               # paper: static HMC, 4 leapfrog steps
    data: Optional[Dict] = None


def _norm_lp(x, loc, scale):
    z = (x - loc) / scale
    return -0.5 * z * z - math.log(scale) - 0.5 * _LOG_2PI


# ---------------------------------------------------------------------------
# 1. 10,000-D Gaussian
# ---------------------------------------------------------------------------
def gaussian_10k(dim: int = 10_000, device=None) -> PaperModel:
    dev = resolve_device(device)
    loc = torch.zeros(dim, device=dev)
    scale = torch.ones(dim, device=dev)

    @model
    def gauss10k():
        sample("x", MvNormalDiag(loc, scale))

    def handwritten(q):  # x: (dim,), identity transform
        return torch.sum(-0.5 * q * q - 0.5 * _LOG_2PI)

    return PaperModel("gaussian_10k", gauss10k(), handwritten, step_size=0.1)


# ---------------------------------------------------------------------------
# 3. Naive Bayes — 1,000 obs, 10 classes, 40 PCA dims (synthetic MNIST-PCA)
# ---------------------------------------------------------------------------
def naive_bayes(n: int = 1_000, n_classes: int = 10, dim: int = 40,
                seed: int = 1, device=None) -> PaperModel:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    true_means = rng.normal(0.0, 3.0, size=(n_classes, dim))
    labels = rng.integers(0, n_classes, size=n)
    x = (true_means[labels] + rng.normal(0.0, 1.0, (n, dim))).astype(np.float32)
    labels = labels.astype(np.int32)

    prior_loc = torch.zeros((n_classes, dim), device=dev)
    prior_scale = 10.0 * torch.ones((n_classes, dim), device=dev)

    @model
    def nb(x, labels):
        mu = sample("mu", MvNormalDiag(prior_loc, prior_scale))
        observe("x", Normal(mu[labels], 1.0), x)

    xt = torch.as_tensor(x, device=dev)
    lt = torch.as_tensor(labels, device=dev)

    def handwritten(q):
        mu = q.reshape(n_classes, dim)
        lp = torch.sum(_norm_lp(mu, 0.0, 10.0))
        return lp + torch.sum(_norm_lp(xt, mu[lt], 1.0))

    return PaperModel("naive_bayes", nb(xt, lt), handwritten, step_size=0.01,
                      data={"x": x, "labels": labels})


# ---------------------------------------------------------------------------
# 4. Logistic Regression — 10,000 obs x 100 dims
# ---------------------------------------------------------------------------
def logreg(n: int = 10_000, dim: int = 100, seed: int = 2,
           device=None) -> PaperModel:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, dim)).astype(np.float32)
    w_true = rng.normal(size=dim) * (rng.random(dim) < 0.3)
    logits = X @ w_true
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-logits))).astype(np.int32)

    prior_loc = torch.zeros(dim, device=dev)
    prior_scale = torch.ones(dim, device=dev)

    @model
    def lr(X, y):
        w = sample("w", MvNormalDiag(prior_loc, prior_scale))
        b = sample("b", Normal(0.0, 3.0))
        observe("y", BernoulliLogits(X @ w + b), y)

    Xt = torch.as_tensor(X, device=dev)
    yt = torch.as_tensor(y, device=dev)
    yf = yt.to(torch.float32)

    def handwritten(q):
        w, b = q[:dim], q[dim]
        lp = torch.sum(_norm_lp(w, 0.0, 1.0)) + _norm_lp(b, 0.0, 3.0)
        logit = Xt @ w + b
        return lp + torch.sum(yf * logit - F.softplus(logit))

    return PaperModel("logreg", lr(Xt, yt), handwritten, step_size=0.002,
                      data={"X": X, "y": y})


MODEL_NAMES = ("gaussian_10k", "naive_bayes", "logreg")

_CONSTRUCTORS = {
    "gaussian_10k": gaussian_10k,
    "naive_bayes": naive_bayes,
    "logreg": logreg,
}


def build(name: str, device=None, **overrides) -> PaperModel:
    """Build a ported Table-1 model on ``device`` (``None`` means CUDA)."""
    if name not in _CONSTRUCTORS:
        raise NotImplementedError(
            f"paper model '{name}' is not ported yet (ported: "
            f"{', '.join(MODEL_NAMES)}); see ROADMAP.md Queue 1")
    return _CONSTRUCTORS[name](device=device, **overrides)
