"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.

  fused_logpdf/  fused elementwise log-density + row reduction for the
                 flat-buffer log-joint (``site_block_sum``): the
                 std_normal, normal, bernoulli_logits, categorical_logits,
                 gamma, beta and student_t families, and the dense
                 MvNormal quadratic form (mvnormal_prec).
  fused_leapfrog/ the whole n-step leapfrog for a separable potential
                 (an opcode table) in one launch for all chains, and the
                 one-shot potential value plus gradient.
  flash_attention/ GQA online-softmax attention over position arrays
                 (causal, sliding window, validity, softcap) for the LM
                 substrate's ``attn_impl="flash"`` route.
  ssd_scan/      the Mamba-2 chunked SSD scan, on the Bayesian LM's
                 scoring path.

The kernels are built with ``nvcc`` at first use (``_build.py``); on a
CPU tensor every wrapper runs the plain version instead.

The PPL's densities reach fused_logpdf through ``site_block_sum`` (the
fused flat-buffer backend: one launch per family per evaluation).
``use_fused_logpdf`` additionally routes the per-site ``total_log_prob``
of ``Normal`` and ``BernoulliLogits`` (at least 1,024 elements) and of
``Categorical`` (logits of rank >= 2, at least 256 labels) onto the
per-array kernels, which is what the ``backend="reference"`` evaluators
run. It is off by default. The JAX package reads its switch when a program
is traced, so a jitted density keeps the route it was traced with; the
port has no tracing step and reads the switch at every evaluation, so
turning it on or off takes effect at the next call of a density built
before.
"""
from __future__ import annotations

import contextlib

from repro_torch.kernels.fused_logpdf import (  # noqa: F401
    bernoulli_logits_logpmf_sum, categorical_logits_logpmf_sum,
    normal_logpdf_sum, site_block_sum)

__all__ = ["fused_logpdf_enabled", "set_fused_logpdf", "use_fused_logpdf",
           "bernoulli_logits_logpmf_sum", "categorical_logits_logpmf_sum",
           "normal_logpdf_sum", "site_block_sum"]

_FUSED_LOGPDF = False


def fused_logpdf_enabled() -> bool:
    return _FUSED_LOGPDF


def set_fused_logpdf(on: bool) -> None:
    global _FUSED_LOGPDF
    _FUSED_LOGPDF = bool(on)


@contextlib.contextmanager
def use_fused_logpdf(on: bool = True):
    prev = _FUSED_LOGPDF
    set_fused_logpdf(on)
    try:
        yield
    finally:
        set_fused_logpdf(prev)
