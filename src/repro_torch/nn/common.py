"""Common NN building blocks (plain PyTorch, dict-of-tensors parameters).

The same functions as ``repro.nn.common``, with the same float32 upcasts:
norms, rotary tables and activations compute in float32 and return the
input's type.
"""
from __future__ import annotations

import math
import zlib
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["dense_init", "embed_init", "rms_norm", "layer_norm", "rope", "apply_rope", "softcap", "swiglu", "geglu",
           "relu2_mlp", "Initializer", "f32_product"]


class Initializer:
    """Deterministic fan-in-scaled normal init keyed by a path string.

    Each path draws from its own ``torch.Generator`` seeded with
    ``(seed, crc32(path))``, so a parameter's values depend on the seed and
    its path alone: the same in every process and in any order of
    creation. (The JAX package keys on Python's ``hash``, which is salted
    per process; its weights are carried across with
    ``repro_torch.convert.params_from_reference``.) On the ``meta`` device
    nothing is drawn: the tensors carry shapes and types only.
    """

    def __init__(self, seed: int = 0, dtype=torch.bfloat16,
                 device=None):
        self.seed = seed
        self.dtype = dtype
        self.device = torch.device("cpu" if device is None else device)

    def key_for(self, path: str) -> int:
        return (self.seed * 0x9E3779B1 + zlib.crc32(path.encode())) % (2 ** 63)

    def _normal(self, path: str, shape: Tuple[int, ...]) -> torch.Tensor:
        if self.device.type == "meta":
            return torch.empty(shape, dtype=torch.float32, device="meta")
        gen = torch.Generator(device=self.device).manual_seed(
            self.key_for(path))
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=self.device)

    def dense(self, path: str, shape: Tuple[int, ...],
              fan_in: Optional[int] = None) -> torch.Tensor:
        fan_in = fan_in if fan_in is not None else shape[0]
        std = 1.0 / math.sqrt(max(fan_in, 1))
        return (self._normal(path, shape) * std).to(self.dtype)

    def embed(self, path: str, shape: Tuple[int, ...]) -> torch.Tensor:
        return self._normal(path, shape).to(self.dtype)

    def zeros(self, path: str, shape: Tuple[int, ...]) -> torch.Tensor:
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def ones(self, path: str, shape: Tuple[int, ...]) -> torch.Tensor:
        return torch.ones(shape, dtype=self.dtype, device=self.device)


def dense_init(gen: torch.Generator, shape, dtype=torch.bfloat16):
    """Fan-in-scaled normal weights, ``N(0, 1 / shape[0])``, drawn in
    float32 from ``gen`` (on its device) and cast to ``dtype``."""
    std = 1.0 / math.sqrt(max(shape[0], 1))
    return (torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                        device=gen.device) * std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.bfloat16):
    """Standard normal embeddings drawn in float32 from ``gen``, cast to
    ``dtype``."""
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                       device=gen.device).to(dtype)


def rms_norm(x, scale, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, unbiased=False, keepdim=True)
    normed = (x32 - mu) * torch.rsqrt(var + eps)
    return (normed * scale.float() + bias.float()).to(x.dtype)


def rope(positions, head_dim: int, base: float = 10000.0):
    """Rotary embedding tables: (..., head_dim//2) cos/sin for positions."""
    half = head_dim // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device)
                      * (math.log(base) / half))
    angles = positions[..., None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """x: (..., seq, heads, head_dim); cos/sin: (..., seq, head_dim//2)."""
    half = x.shape[-1] // 2
    c = cos[..., None, :]
    s = sin[..., None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * c - x2f * s, x2f * c + x1f * s], dim=-1)
    return out.to(x.dtype)


def softcap(x, cap: Optional[float]):
    """Gemma-2 style logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ w_down


def geglu(x, w_gate, w_up, w_down):
    g = x @ w_gate
    u = x @ w_up
    h = F.gelu(g.float(), approximate="tanh").to(x.dtype) * u
    return h @ w_down


def relu2_mlp(x, w_up, w_down):
    """Squared-ReLU MLP (Nemotron/Minitron style, non-gated)."""
    h = torch.relu((x @ w_up).float())
    return (h * h).to(x.dtype) @ w_down


class _LowPrecisionProduct(torch.autograd.Function):
    """x2 (N, D) @ table (V, D)^T in bf16 with a float32 result (cuBLAS's
    bf16 product, float32 accumulation and output: ``torch.mm``'s
    ``out_dtype``, which autograd does not differentiate). Backward: the
    float32 cotangent rounded to bf16 for the two products, each
    accumulated in float32 and rounded once to its operand's type (the
    bf16 passes a TPU's default precision runs; Queue 3 B5)."""

    @staticmethod
    def forward(x2, table):
        return torch.mm(x2, table.T, out_dtype=torch.float32)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        x2, table = ctx.saved_tensors
        g = g.to(x2.dtype)
        dx = torch.mm(g, table) if ctx.needs_input_grad[0] else None
        dt = torch.mm(g.T, x2) if ctx.needs_input_grad[1] else None
        return dx, dt


def f32_product(x, table):
    """x (B,S,D) @ table (V,D)^T with a float32 result, as the JAX
    package's ``preferred_element_type=float32``: float32 (and float64)
    operands as they are; bf16 operands through cuBLAS's bf16 product with
    float32 output on the card (``_LowPrecisionProduct``), or upcast on
    the CPU."""
    if x.dtype in (torch.float32, torch.float64):
        return x @ table.T
    if x.is_cuda:
        out = _LowPrecisionProduct.apply(x.reshape(-1, x.shape[-1]), table)
        return out.reshape(*x.shape[:-1], table.shape[0])
    return x.float() @ table.float().T
