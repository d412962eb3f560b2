"""repro_torch — the PyTorch/CUDA port of the typed-trace PPL.

Mirrors ``repro``'s module tree and public names. Plain tensor code is
PyTorch; the kernels the JAX package wrote in Pallas are CUDA kernels
written for Hopper (``kernels/*/csrc``). Entry points
run on the card unless the caller passes ``device="cpu"``.
"""
from repro_torch.core import (DefaultContext, LikelihoodContext,
                              MiniBatchContext, Model, ModelGen, PriorContext,
                              TypedVarInfo, UntypedVarInfo, cache_stats,
                              deterministic, factor, missing, model, observe,
                              prior_factor, prob, program_cache, reject,
                              reject_if, sample, submodel, tilde, typify)

__all__ = [
    "model", "Model", "ModelGen", "sample", "observe", "tilde", "missing",
    "deterministic", "factor", "prior_factor", "submodel", "reject",
    "reject_if", "typify", "UntypedVarInfo", "TypedVarInfo",
    "DefaultContext", "LikelihoodContext", "PriorContext", "MiniBatchContext",
    "prob", "program_cache", "cache_stats",
]
