"""gemma2-27b [dense] — arXiv:2408.00118 (hf-verified).

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000; alternating
local(window 4096)/global attention, attn logit softcap 50, final logit
softcap 30, GeGLU, post-block norms, head_dim=128."""
import torch

from repro_torch.nn.lm import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36_864,
    vocab=256_000,
    head_dim=128,
    mlp_type="geglu",
    layer_pattern=("local", "global"),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norm=True,
    dtype=torch.bfloat16,
)

SMOKE = ArchConfig(
    name="gemma2-27b-smoke",
    family="dense",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    head_dim=16,
    mlp_type="geglu",
    layer_pattern=("local", "global"),
    window=16,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norm=True,
    dtype=torch.float32,
    remat=False,
)
