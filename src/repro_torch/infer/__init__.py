"""repro_torch.infer — inference over typed traces.

Every sampler runs the SAME fused flat-buffer log-density
(``Model.make_logdensity_fn(..., backend="fused")``); ``run_chains`` runs
all chains in lockstep on one device.
"""
from repro_torch.infer.chains import (Chain, TransitionKernel,
                                      effective_sample_size, package_draws,
                                      run_chains, split_rhat)
from repro_torch.infer.hmc import HMC, DualAveraging

__all__ = ["HMC", "DualAveraging", "Chain", "TransitionKernel",
           "effective_sample_size", "package_draws", "run_chains",
           "split_rhat"]
