"""internvl2-26b [vlm] — arXiv:2404.16821 (InternViT-6B + InternLM2-20B).

Backbone (InternLM2-20B): 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553. The InternViT frontend is a STUB per the assignment: 1024 precomputed
patch embeddings are projected and prepended to the token sequence."""
import torch

from repro_torch.nn.lm import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16_384,
    vocab=92_553,
    head_dim=128,
    layer_pattern=("global",),
    n_prefix=1024,             # ViT patch embeddings (stub)
    dtype=torch.bfloat16,
)

SMOKE = ArchConfig(
    name="internvl2-26b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    head_dim=16,
    layer_pattern=("global",),
    n_prefix=8,
    dtype=torch.float32,
    remat=False,
)
