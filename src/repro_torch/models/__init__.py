"""repro_torch.models — the paper's Table-1 models (and eight schools),
and the two synthetic family mixes of the JAX package's benchmarks and
tests."""
from repro_torch.models.family_mix import (SYNTHETIC_NAMES, build_synthetic,
                                           family_mix_8k, mixed)
from repro_torch.models.paper_suite import MODEL_NAMES, PaperModel, build

__all__ = ["MODEL_NAMES", "PaperModel", "build", "SYNTHETIC_NAMES",
           "build_synthetic", "family_mix_8k", "mixed"]
