"""deepseek-v2-lite-16b [moe] — arXiv:2405.04434 (hf-verified).

27L d_model=2048 16H d_ff=1408 (expert) vocab=102400; MLA kv_lora=512
(qk_nope=128, qk_rope=64, v_head=128); MoE: 64 routed top-6 + 2 shared
experts, layer 0 dense (d_ff 10944)."""
import torch

from repro_torch.nn.lm import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,                 # routed-expert hidden size
    vocab=102_400,
    layer_pattern=("mla",),
    mla=True,
    kv_lora=512,
    qk_nope=128,
    qk_rope=64,
    v_head=128,
    moe=True,
    n_experts=64,
    top_k=6,
    n_shared=2,
    d_shared=2 * 1408,
    first_dense=1,
    dense_ff=10_944,
    dtype=torch.bfloat16,
)

SMOKE = ArchConfig(
    name="deepseek-v2-lite-16b-smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=32,
    vocab=256,
    layer_pattern=("mla",),
    mla=True,
    kv_lora=32,
    qk_nope=16,
    qk_rope=8,
    v_head=16,
    moe=True,
    n_experts=4,
    top_k=2,
    n_shared=1,
    d_shared=32,
    first_dense=1,
    dense_ff=128,
    dtype=torch.float32,
    remat=False,
)
