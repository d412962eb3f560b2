"""seamless-m4t-large-v2 [audio] — arXiv:2308.11596 (enc-dec, hf-verified).

24L decoder + 24L encoder, d_model=1024 16H (kv=16) d_ff=8192
vocab=256206. The speech frontend (w2v-BERT feature extractor) is a STUB
per the assignment: 960 precomputed frame embeddings are consumed by
the text-free encoder; the decoder cross-attends
to encoder memory."""
import torch

from repro_torch.nn.lm import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256_206,
    layer_pattern=("global",),
    enc_layers=24,
    n_prefix=960,              # audio frame embeddings (stub)
    dtype=torch.bfloat16,
)

SMOKE = ArchConfig(
    name="seamless-m4t-large-v2-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    layer_pattern=("global",),
    enc_layers=2,
    n_prefix=16,
    dtype=torch.float32,
    remat=False,
)
