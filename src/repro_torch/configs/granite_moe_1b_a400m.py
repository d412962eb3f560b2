"""granite-moe-1b-a400m [moe] — hf:ibm-granite/granite-3.0-1b-a400m-base.

24L d_model=1024 16H (GQA kv=8) d_ff=512 (expert) vocab=49155; 32 experts
top-8, no shared experts."""
import torch

from repro_torch.nn.lm import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49_155,
    layer_pattern=("global",),
    moe=True,
    n_experts=32,
    top_k=8,
    dtype=torch.bfloat16,
)

SMOKE = ArchConfig(
    name="granite-moe-1b-a400m-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=32,
    vocab=256,
    layer_pattern=("global",),
    moe=True,
    n_experts=4,
    top_k=2,
    dtype=torch.float32,
    remat=False,
)
