"""repro_torch.core — typed traces, DSL, contexts."""
from repro_torch.core.contexts import (Context, DefaultContext,
                                       LikelihoodContext, MiniBatchContext,
                                       PriorContext)
from repro_torch.core.interpreters import (EarlyRejectError, Evaluator,
                                           LinkedEvaluator, Sampler)
from repro_torch.core.model import Model, ModelGen, model
from repro_torch.core.primitives import (deterministic, factor, get_logp,
                                         missing, observe, prior_factor,
                                         reject, reject_if, sample, set_logp,
                                         submodel, tilde)
from repro_torch.core.program import (CompiledProgram, ProgramCache,
                                      ProgramKey, cache_stats, clear_cache,
                                      program_cache)
from repro_torch.core.queries import parse_query, prepare_query, prob
from repro_torch.core.varinfo import (SiteMeta, TypedVarInfo, UntypedVarInfo,
                                      typify)
from repro_torch.core.varname import VarName

__all__ = [
    "model", "Model", "ModelGen",
    "sample", "observe", "tilde", "missing", "deterministic", "factor",
    "prior_factor", "submodel",
    "reject", "reject_if", "set_logp", "get_logp",
    "Context", "DefaultContext", "LikelihoodContext", "PriorContext",
    "MiniBatchContext",
    "UntypedVarInfo", "TypedVarInfo", "typify", "SiteMeta", "VarName",
    "Sampler", "Evaluator", "LinkedEvaluator", "EarlyRejectError",
    "CompiledProgram", "ProgramCache", "ProgramKey",
    "program_cache", "cache_stats", "clear_cache",
    "prob", "parse_query", "prepare_query",
]
