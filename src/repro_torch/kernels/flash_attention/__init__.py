"""GQA flash attention: a hand-written CUDA kernel for Hopper
(``csrc/flash_attention.cu``) beside its plain PyTorch version
(``ref.py``)."""
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    LAUNCHES, flash_attention_gqa, reset_launch_counts)
