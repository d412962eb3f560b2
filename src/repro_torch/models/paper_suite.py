"""The paper's 8 Table-1 models (and eight schools), with hand-written
analogues.

Each constructor returns a ``PaperModel`` with:
* ``model``        — the DSL version (typed-trace path),
* ``handwritten``  — a hand-coded log-density over the SAME flat
  unconstrained layout (the Stan analogue),
* deterministic synthetic data at the paper's stated sizes, drawn by the
  same ``np.random.default_rng(seed)`` calls as the JAX package's
  constructors, so the data are equal bit for bit,
* the static-HMC settings (4 leapfrog steps; per-model step sizes).

Table 1 sizes:
  gaussian_10k   : 10,000-D standard normal (separable: fused integrator)
  gauss_unknown  : 10,000 1-D observations, unknown mean+variance
  naive_bayes    : 1,000 obs of MNIST->PCA-40 (synthetic stand-in), 10 classes
  logreg         : 10,000 obs x 100 dims
  hier_poisson   : 50 obs, 10 groups
  sto_volatility : 500 obs (its AR(1) path as one matrix product)
  hmm_semisup    : K=5 latent, V=20 symbols, T=300 (200 unsupervised)
  lda            : V=100, K=5, D=10 docs, ~1,000 words each
and eight_schools (not in Table 1: the conditionally separable hierarchy;
the port runs it under the autodiff integrator until the conditional
spec lands, ROADMAP.md Queue 1 item 5).

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
from repro_torch.bijectors import StickBreaking
from repro_torch.core import factor, model, observe, sample
from repro_torch.dists import (BernoulliLogits, Categorical, Dirichlet, Gamma,
                               HalfCauchy, HalfNormal, InverseGamma,
                               MvNormalDiag, Normal, Poisson, Uniform)

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
    log_scale = torch.log(scale) if torch.is_tensor(scale) else math.log(scale)
    return -0.5 * z * z - log_scale - 0.5 * _LOG_2PI


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
# 2. Gaussian with unknown mean and variance, 10,000 observations
# ---------------------------------------------------------------------------
def gauss_unknown(n: int = 10_000, seed: int = 0, device=None) -> PaperModel:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    y = rng.normal(1.5, 0.7, size=n).astype(np.float32)

    @model
    def gdemo(y):
        s = sample("s", InverseGamma(2.0, 3.0))
        m = sample("m", Normal(0.0, torch.sqrt(s)))
        observe("y", Normal(m, torch.sqrt(s)), y)

    yt = torch.as_tensor(y, device=dev)

    def handwritten(q):
        u_s, m = q[0], q[1]
        s = torch.exp(u_s)
        a, b = 2.0, 3.0
        lp = (a * math.log(b) - (a + 1.0) * torch.log(s) - b / s
              - math.lgamma(a)) + u_s  # + log|d s/d u|
        sd = torch.sqrt(s)
        lp = lp + _norm_lp(m, 0.0, sd)
        return lp + torch.sum(_norm_lp(yt, m, sd))

    return PaperModel("gauss_unknown", gdemo(yt), handwritten, step_size=0.01,
                      data={"y": y})


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


# ---------------------------------------------------------------------------
# 5. Hierarchical Poisson — 50 obs, 10 groups
# ---------------------------------------------------------------------------
def hier_poisson(n: int = 50, n_groups: int = 10, seed: int = 3,
                 device=None) -> PaperModel:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    groups = rng.integers(0, n_groups, size=n).astype(np.int32)
    a0_true, a1_true = 1.0, rng.normal(0.0, 0.4, size=n_groups)
    log_exposure = np.log(rng.uniform(0.5, 2.0, size=n)).astype(np.float32)
    y = rng.poisson(np.exp(a0_true + a1_true[groups] + log_exposure)).astype(np.int32)

    prior_loc = torch.zeros(n_groups, device=dev)
    prior_scale = torch.ones(n_groups, device=dev)

    @model
    def hp(y, groups, log_exposure):
        a0 = sample("a0", Normal(0.0, 10.0))
        sigma = sample("sigma", Gamma(1.0, 1.0))
        a1_std = sample("a1_std", MvNormalDiag(prior_loc, prior_scale))
        a1 = a1_std * sigma  # non-centred
        observe("y", Poisson(torch.exp(a0 + a1[groups] + log_exposure)), y)

    yt = torch.as_tensor(y, device=dev)
    gt = torch.as_tensor(groups, device=dev)
    let = torch.as_tensor(log_exposure, device=dev)
    yf = yt.to(torch.float32)
    lgamma_y1 = torch.lgamma(yf + 1.0)

    def handwritten(q):
        a0, u_sig = q[0], q[1]
        a1_std = q[2:]
        sigma = torch.exp(u_sig)
        lp = _norm_lp(a0, 0.0, 10.0)
        lp = lp + (-sigma) + u_sig  # Gamma(1,1) logpdf + jacobian
        lp = lp + torch.sum(_norm_lp(a1_std, 0.0, 1.0))
        lam = torch.exp(a0 + (a1_std * sigma)[gt] + let)
        return lp + torch.sum(torch.xlogy(yf, lam) - lam - lgamma_y1)

    return PaperModel("hier_poisson", hp(yt, gt, let), handwritten,
                      step_size=0.02, data={"y": y, "groups": groups})


def _ar1_path(T: int, device):
    """``(mu, phi, sigma, h_std) -> h`` for the non-centred AR(1) latent
    log-volatility: ``h_0 = mu + sigma / sqrt(1 - phi^2) h_std_0`` and
    ``h_t = mu + phi (h_{t-1} - mu) + sigma h_std_t``. The JAX package
    runs the 499-step recurrence as a ``lax.scan``; here it is its closed
    form ``h_t - mu = sigma sum_{s <= t} phi^(t-s) e_s`` (``e_0 = h_std_0 /
    sqrt(1 - phi^2)``, ``e_s = h_std_s``): one (T, T) power matrix and one
    matrix-vector product, a few launches per evaluation where a Python
    loop under ``torch.func`` would take thousands."""
    t = torch.arange(T, device=device, dtype=torch.float32)
    lag = t[:, None] - t[None, :]
    lower = (lag >= 0).to(torch.float32)
    lag = lag.clamp(min=0.0)  # phi^0 above the diagonal, masked to 0

    def path(mu, phi, sigma, h_std):
        e = torch.cat([h_std[:1] / torch.sqrt(1.0 - phi * phi), h_std[1:]])
        return mu + sigma * ((torch.pow(phi, lag) * lower) @ e)

    return path


# ---------------------------------------------------------------------------
# 6. Stochastic Volatility — 500 obs (non-centred AR(1) latent log-vol)
# ---------------------------------------------------------------------------
def sto_volatility(T: int = 500, seed: int = 4, device=None) -> PaperModel:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    phi_t, sig_t, mu_t = 0.95, 0.25, -1.0
    h = np.empty(T)
    h[0] = rng.normal(mu_t, sig_t / np.sqrt(1 - phi_t ** 2))
    for t in range(1, T):
        h[t] = mu_t + phi_t * (h[t - 1] - mu_t) + rng.normal(0, sig_t)
    y = (rng.normal(size=T) * np.exp(h / 2)).astype(np.float32)

    path = _ar1_path(T, dev)
    loc0, scale1 = torch.zeros(T, device=dev), torch.ones(T, device=dev)

    @model
    def sv(y):
        phi = sample("phi", Uniform(-1.0, 1.0))
        sigma = sample("sigma", HalfCauchy(1.0))
        mu = sample("mu", Normal(-1.0, 1.0))
        h_std = sample("h_std", MvNormalDiag(loc0, scale1))
        h = path(mu, phi, sigma, h_std)
        observe("y", Normal(0.0, torch.exp(h / 2.0)), y)

    yt = torch.as_tensor(y, device=dev)

    def handwritten(q):
        u_phi, u_sig, mu = q[0], q[1], q[2]
        h_std = q[3:]
        # phi: sigmoid to (-1,1) + jacobian
        phi = -1.0 + 2.0 * torch.sigmoid(u_phi)
        lp = -math.log(2.0)  # Uniform(-1,1) density
        lp = lp + (math.log(2.0) - F.softplus(u_phi) - F.softplus(-u_phi))
        sigma = torch.exp(u_sig)
        lp = lp + (math.log(2.0) - math.log(math.pi)
                   - torch.log1p(sigma ** 2)) + u_sig
        lp = lp + _norm_lp(mu, -1.0, 1.0)
        lp = lp + torch.sum(_norm_lp(h_std, 0.0, 1.0))
        h = path(mu, phi, sigma, h_std)
        return lp + torch.sum(_norm_lp(yt, 0.0, torch.exp(h / 2.0)))

    return PaperModel("sto_volatility", sv(yt), handwritten, step_size=0.01,
                      data={"y": y})


def _dirichlet_lp(x, conc):
    """Dirichlet log-density of the rows of ``x``, summed (the twins')."""
    return (torch.sum(torch.xlogy(conc - 1.0, x))
            - torch.sum(torch.lgamma(conc))
            + torch.sum(torch.lgamma(torch.sum(conc, -1))))


def _hmm_forward(log_theta, emis, start):
    """Forward algorithm over the unsupervised segment: ``emis (K, T)`` are
    the emission log-probabilities of its words, ``start`` the last
    supervised state; returns log p(words | theta, phi)."""
    alpha = log_theta[start] + emis[:, 0]
    for t in range(1, emis.shape[1]):
        alpha = torch.logsumexp(alpha[:, None] + log_theta, dim=0) + emis[:, t]
    return torch.logsumexp(alpha, dim=0)


# ---------------------------------------------------------------------------
# 7. Semi-supervised HMM — K=5, V=20, T=300 (first 100 supervised)
# ---------------------------------------------------------------------------
def hmm_semisup(K: int = 5, V: int = 20, T: int = 300, T_sup: int = 100,
                seed: int = 5, device=None) -> PaperModel:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    theta_t = rng.dirichlet(np.full(K, 2.0), size=K)   # transitions
    phi_t = rng.dirichlet(np.full(V, 0.5), size=K)     # emissions
    z = np.empty(T, dtype=np.int64)
    w = np.empty(T, dtype=np.int64)
    z[0] = rng.integers(K)
    w[0] = rng.choice(V, p=phi_t[z[0]])
    for t in range(1, T):
        z[t] = rng.choice(K, p=theta_t[z[t - 1]])
        w[t] = rng.choice(V, p=phi_t[z[t]])
    w_sup, z_sup = w[:T_sup].astype(np.int32), z[:T_sup].astype(np.int32)
    w_unsup = w[T_sup:].astype(np.int32)

    alpha = torch.full((K, K), 2.0, device=dev)
    beta = torch.full((K, V), 0.5, device=dev)
    # int32 labels (the categorical kernel's type) and int64 indices, each
    # built once, so no evaluation converts
    ws_t, zs_t, wu_t = (torch.as_tensor(a, device=dev)
                        for a in (w_sup, z_sup, w_unsup))
    zs_idx, wu_idx = zs_t.long(), wu_t.long()
    z_last = int(z_sup[-1])

    @model
    def hmm(w_sup, z_sup, w_unsup):
        theta = sample("theta", Dirichlet(alpha))  # (K,K) rows
        phi = sample("phi", Dirichlet(beta))       # (K,V) rows
        log_theta, log_phi = torch.log(theta), torch.log(phi)
        # supervised segment: categorical transitions + emissions
        observe("z_sup", Categorical(log_theta[zs_idx[:-1]]), z_sup[1:])
        observe("w_sup", Categorical(log_phi[zs_idx]), w_sup)
        # unsupervised segment: forward algorithm marginalising z
        factor("w_unsup", _hmm_forward(log_theta, log_phi[:, wu_idx], z_last))

    def handwritten(q):
        sb = StickBreaking()
        u_theta = q[:K * (K - 1)].reshape(K, K - 1)
        u_phi = q[K * (K - 1):K * (K - 1) + K * (V - 1)].reshape(K, V - 1)
        theta, phi = sb.forward(u_theta), sb.forward(u_phi)
        lp = (sb.forward_log_det_jacobian(u_theta)
              + sb.forward_log_det_jacobian(u_phi))
        lp = lp + _dirichlet_lp(theta, alpha) + _dirichlet_lp(phi, beta)
        log_theta, log_phi = torch.log(theta), torch.log(phi)
        lp = lp + torch.sum(torch.gather(
            torch.log_softmax(log_theta[zs_idx[:-1]], -1), -1,
            zs_idx[1:, None]))
        lp = lp + torch.sum(torch.gather(
            torch.log_softmax(log_phi[zs_idx], -1), -1, ws_t.long()[:, None]))
        return lp + _hmm_forward(log_theta, log_phi[:, wu_idx], z_last)

    return PaperModel("hmm_semisup", hmm(ws_t, zs_t, wu_t), handwritten,
                      step_size=0.01,
                      data={"w_sup": w_sup, "z_sup": z_sup, "w_unsup": w_unsup})


# ---------------------------------------------------------------------------
# 8. LDA — V=100, K=5, D=10, ~1,000 words per doc (collapsed z)
# ---------------------------------------------------------------------------
def lda(V: int = 100, K: int = 5, D: int = 10, avg_len: int = 1_000,
        seed: int = 6, device=None) -> PaperModel:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    phi_t = rng.dirichlet(np.full(V, 0.1), size=K)
    theta_t = rng.dirichlet(np.full(K, 0.5), size=D)
    doc_ids, words = [], []
    for d in range(D):
        n_d = int(rng.poisson(avg_len))
        zs = rng.choice(K, size=n_d, p=theta_t[d])
        ws = np.array([rng.choice(V, p=phi_t[z]) for z in zs])
        doc_ids.append(np.full(n_d, d)); words.append(ws)
    doc_ids = np.concatenate(doc_ids).astype(np.int32)
    words = np.concatenate(words).astype(np.int32)

    alpha = torch.full((D, K), 1.0, device=dev)
    beta = torch.full((K, V), 0.5, device=dev)
    dt = torch.as_tensor(doc_ids, device=dev)
    wt = torch.as_tensor(words, device=dev)  # int32: the kernel's labels
    d_idx, w_idx = dt.long(), wt.long()

    @model
    def lda_m(doc_ids, words):
        theta = sample("theta", Dirichlet(alpha))  # (D,K)
        phi = sample("phi", Dirichlet(beta))       # (K,V)
        # collapsed topic assignment: word ~ Categorical(theta[d] @ phi)
        word_probs = theta[d_idx] @ phi            # (N,V)
        observe("w", Categorical(torch.log(word_probs)), words)

    def handwritten(q):
        sb = StickBreaking()
        u_theta = q[:D * (K - 1)].reshape(D, K - 1)
        u_phi = q[D * (K - 1):D * (K - 1) + K * (V - 1)].reshape(K, V - 1)
        theta, phi = sb.forward(u_theta), sb.forward(u_phi)
        lp = (sb.forward_log_det_jacobian(u_theta)
              + sb.forward_log_det_jacobian(u_phi))
        lp = lp + _dirichlet_lp(theta, alpha) + _dirichlet_lp(phi, beta)
        word_probs = theta[d_idx] @ phi
        return lp + torch.sum(torch.log(torch.gather(
            word_probs, -1, w_idx[:, None])))

    return PaperModel("lda", lda_m(dt, wt), handwritten, step_size=0.005,
                      data={"doc_ids": doc_ids, "words": words})


# ---------------------------------------------------------------------------
# Eight schools (Rubin 1981) — the canonical conditionally separable
# hierarchy: (mu, tau) couple every theta_i, but GIVEN (mu, tau) the thetas
# are independent Normals with a Normal likelihood attached. Not a Table-1
# model; the JAX package runs it through its conditional potential spec.
# ---------------------------------------------------------------------------
def eight_schools(device=None) -> PaperModel:
    dev = resolve_device(device)
    y = np.asarray([28., 8., -3., 7., -1., 1., 18., 12.], dtype=np.float32)
    sigma = np.asarray([15., 10., 16., 11., 9., 11., 10., 18.],
                       dtype=np.float32)
    ones = torch.ones(8, device=dev)

    @model
    def schools(y, sigma):
        mu = sample("mu", Normal(0.0, 5.0))
        tau = sample("tau", HalfNormal(5.0))
        theta = sample("theta", Normal(mu * ones, tau))
        observe("y", Normal(theta, sigma), y)

    yt, st = torch.as_tensor(y, device=dev), torch.as_tensor(sigma, device=dev)

    def handwritten(q):  # layout: mu, u_tau = log tau, theta[0:8]
        mu, u_tau, theta = q[0], q[1], q[2:10]
        tau = torch.exp(u_tau)
        lp = _norm_lp(mu, 0.0, 5.0)
        lp = lp + (0.5 * math.log(2.0 / math.pi) - math.log(5.0)
                   - 0.5 * (tau / 5.0) ** 2 + u_tau)
        lp = lp + torch.sum(_norm_lp(theta, mu, tau))
        return lp + torch.sum(_norm_lp(yt, theta, st))

    return PaperModel("eight_schools", schools(yt, st), handwritten,
                      step_size=0.1, data={"y": y, "sigma": sigma})


MODEL_NAMES = ("gaussian_10k", "gauss_unknown", "naive_bayes", "logreg",
               "hier_poisson", "sto_volatility", "hmm_semisup", "lda")

_BUILDERS = {
    "eight_schools": eight_schools,
    "gaussian_10k": gaussian_10k,
    "gauss_unknown": gauss_unknown,
    "naive_bayes": naive_bayes,
    "logreg": logreg,
    "hier_poisson": hier_poisson,
    "sto_volatility": sto_volatility,
    "hmm_semisup": hmm_semisup,
    "lda": lda,
}


def build(name: str, device=None, **overrides) -> PaperModel:
    """Build a paper model on ``device`` (``None`` means CUDA); an unknown
    name raises ``KeyError``, as the JAX package's ``build`` does."""
    return _BUILDERS[name](device=device, **overrides)
