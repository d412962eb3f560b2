"""granite-8b [dense] — arXiv:2405.04324 (llama-arch, code; hf-verified).

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152."""
import torch

from repro_torch.nn.lm import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab=49_152,
    layer_pattern=("global",),
    dtype=torch.bfloat16,
)

SMOKE = ArchConfig(
    name="granite-8b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    layer_pattern=("global",),
    dtype=torch.float32,
    remat=False,
)
