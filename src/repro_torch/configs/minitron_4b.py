"""minitron-4b [dense] — arXiv:2407.14679 (pruned nemotron, hf-verified).

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000; squared-ReLU MLP."""
import torch

from repro_torch.nn.lm import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=9216,
    vocab=256_000,
    head_dim=128,
    mlp_type="relu2",
    layer_pattern=("global",),
    dtype=torch.bfloat16,
)

SMOKE = ArchConfig(
    name="minitron-4b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    head_dim=16,
    mlp_type="relu2",
    layer_pattern=("global",),
    dtype=torch.float32,
    remat=False,
)
