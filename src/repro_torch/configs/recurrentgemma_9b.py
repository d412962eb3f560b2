"""recurrentgemma-9b [hybrid] — arXiv:2402.19427 (Griffin).

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000; repeating
[RG-LRU, RG-LRU, local-attn(2048)] blocks (recurrent:attention = 2:1),
lru_width=4096. Decode state is O(1): RG-LRU hidden + 2048-slot ring
buffers — the property that makes long_500k feasible."""
import torch

from repro_torch.nn.lm import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12_288,
    vocab=256_000,
    head_dim=256,
    mlp_type="geglu",
    layer_pattern=("rglru", "rglru", "local"),
    window=2048,
    lru_width=4096,
    dtype=torch.bfloat16,
)

SMOKE = ArchConfig(
    name="recurrentgemma-9b-smoke",
    family="hybrid",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=128,
    vocab=256,
    head_dim=16,
    mlp_type="geglu",
    layer_pattern=("rglru", "rglru", "local"),
    window=16,
    lru_width=64,
    dtype=torch.float32,
    remat=False,
)
