"""Deterministic synthetic token pipeline with per-host sharding, as
``repro.data.synthetic``.

Production data loaders must be (1) deterministic under restart — batch t
depends only on (seed, t), never on loader state — and (2) host-sharded —
each host materialises ONLY its slice of the global batch. Both properties
are load-bearing for fault tolerance: after a preemption the run resumes
at step t with bit-identical data, and after an elastic re-mesh the new
host set re-shards the same global batch without coordination.

Each batch is drawn on a CPU ``torch.Generator`` seeded from ``(seed,
step)`` alone (through ``numpy.random.SeedSequence``) and then moved to the
device, so the CPU and the card see the same tokens. The bits differ from
``repro``'s threefry stream; the law is the same: geometric-length
documents separated by EOS, token ids Zipf-ish via a squared-uniform
transform (frequency skew exercises the same embedding-gather patterns as
natural text).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch._device import resolve_device

__all__ = ["ShapeDtype", "SyntheticTokens", "host_shard"]


def host_shard(global_batch: int, host_id: int, num_hosts: int
               ) -> Tuple[int, int]:
    """[start, stop) rows of the global batch owned by ``host_id``."""
    if global_batch % num_hosts != 0:
        raise ValueError(
            f"global_batch {global_batch} not divisible by hosts {num_hosts}")
    per = global_batch // num_hosts
    return host_id * per, (host_id + 1) * per


class ShapeDtype(NamedTuple):
    """A batch entry's shape and type (``jax.ShapeDtypeStruct``'s role)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class SyntheticTokens:
    """Stateless batch generator: ``batch(step)`` is a pure function.

    ``device`` is where batches land: the card unless the caller asks for
    the CPU (``None`` means CUDA)."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512
    eos_id: int = 0
    device: Optional[Union[str, torch.device]] = None

    def _generator(self, step: int) -> torch.Generator:
        words = np.random.SeedSequence([int(self.seed), int(step)]) \
            .generate_state(2, np.uint32)
        return torch.Generator().manual_seed(
            (int(words[0]) << 31) ^ int(words[1]))

    def batch(self, step: int, host_id: int = 0, num_hosts: int = 1
              ) -> Dict[str, torch.Tensor]:
        """This host's {tokens, labels} (int32) for global step ``step``.

        labels are next-token targets (shift-left of tokens; one extra
        position is drawn for the last target). Document boundaries are
        injected via a Bernoulli EOS process with rate 1/mean_doc_len.
        """
        lo, hi = host_shard(self.global_batch, host_id, num_hosts)
        device = resolve_device(self.device)
        gen = self._generator(step)
        shape = (self.global_batch, self.seq_len + 1)
        # draw the FULL global batch's randomness, slice this host's rows —
        # determinism across host counts (elastic re-mesh safe)
        u = torch.rand(shape, generator=gen)[lo:hi]
        e = torch.rand(shape, generator=gen)[lo:hi]
        # squared-uniform -> low ids frequent (Zipf-ish skew)
        toks = (u * u * (self.vocab - 2)).to(torch.int32) + 1
        toks = torch.where(e < 1.0 / self.mean_doc_len,
                           torch.tensor(self.eos_id, dtype=torch.int32), toks)
        return {"tokens": toks[:, :-1].contiguous().to(device),
                "labels": toks[:, 1:].contiguous().to(device)}

    def iter_batches(self, start_step: int = 0, host_id: int = 0,
                     num_hosts: int = 1) -> Iterator[Dict[str, torch.Tensor]]:
        step = start_step
        while True:
            yield self.batch(step, host_id, num_hosts)
            step += 1

    def spec(self, host_id: int = 0, num_hosts: int = 1
             ) -> Dict[str, ShapeDtype]:
        lo, hi = host_shard(self.global_batch, host_id, num_hosts)
        shape = (hi - lo, self.seq_len)
        return {"tokens": ShapeDtype(shape, torch.int32),
                "labels": ShapeDtype(shape, torch.int32)}
