"""mamba2-1.3b [ssm] — arXiv:2405.21060 (SSD / state-space duality).

48L d_model=2048 attn-free vocab=50280; d_inner=2*d_model=4096,
d_state=128, head_dim=64 (64 SSM heads), chunked scan (chunk=128).
Decode state is O(1): (B, H, N, P) SSM state + conv tail."""
import torch

from repro_torch.nn.lm import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50_280,
    layer_pattern=("ssd",),
    d_state=128,
    d_inner=4096,
    ssm_head_dim=64,
    chunk=128,
    n_groups=1,
    dtype=torch.bfloat16,
)

SMOKE = ArchConfig(
    name="mamba2-1.3b-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=256,
    layer_pattern=("ssd",),
    d_state=16,
    d_inner=128,
    ssm_head_dim=32,
    chunk=32,
    n_groups=1,
    dtype=torch.float32,
    remat=False,
)
