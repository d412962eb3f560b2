"""repro_torch.infer — inference over typed traces.

Every sampler runs the SAME fused flat-buffer log-density
(``Model.make_logdensity_fn(..., backend="fused")``, cached by
``core/program.py``); ``run_chains`` runs all chains in lockstep on one
device.
"""
from repro_torch.infer.advi import ADVI, ADVIResult
from repro_torch.infer.chains import (Chain, TransitionKernel,
                                      effective_sample_size, package_draws,
                                      run_chains, setup_chain_driver,
                                      split_rhat)
from repro_torch.infer.driver import ChainHealth, run_segmented
from repro_torch.infer.hmc import HMC, DualAveraging
from repro_torch.infer.map_estimate import MAP
from repro_torch.infer.mh import RWMH
from repro_torch.infer.nuts import NUTS
from repro_torch.infer.sgld import SGLD, make_sgld_step, make_subsampled_sgld_step

__all__ = [
    "HMC", "NUTS", "RWMH", "SGLD", "make_sgld_step",
    "make_subsampled_sgld_step", "ADVI", "ADVIResult",
    "MAP", "Chain", "ChainHealth", "TransitionKernel",
    "effective_sample_size", "package_draws", "run_chains", "run_segmented",
    "setup_chain_driver", "split_rhat", "DualAveraging",
]
