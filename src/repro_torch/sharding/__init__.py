"""repro_torch.sharding — the subsampled (minibatch) log-density.

Only ``repro.sharding.minibatch``'s estimator is ported: it needs no
device mesh. The rest of ``repro.sharding`` (``Rules``, meshes,
``data_parallel`` and ``run_chains(mesh=)``) waits for ROADMAP.md Queue 1
item 8 (sharding on ``torch.distributed``).
"""
from repro_torch.sharding.minibatch import (Minibatch, MinibatchLogDensity,
                                            make_minibatch_logdensity)

__all__ = ["Minibatch", "MinibatchLogDensity", "make_minibatch_logdensity"]
