"""smollm-360m [dense] — hf:HuggingFaceTB/SmolLM-360M (llama-arch small).

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152."""
import torch

from repro_torch.nn.lm import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab=49_152,
    layer_pattern=("global",),
    dtype=torch.bfloat16,
)

SMOKE = ArchConfig(
    name="smollm-360m-smoke",
    family="dense",
    n_layers=2,
    d_model=60,
    n_heads=3,
    n_kv_heads=1,
    d_ff=128,
    vocab=256,
    layer_pattern=("global",),
    dtype=torch.float32,
    remat=False,
)
