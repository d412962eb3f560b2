"""repro_torch.models — the paper's Table-1 models ported so far."""
from repro_torch.models.paper_suite import MODEL_NAMES, PaperModel, build

__all__ = ["MODEL_NAMES", "PaperModel", "build"]
