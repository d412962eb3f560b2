"""Fused leapfrog: the whole n-step integrator for a separable potential
(``spec.py``'s opcode table) as one kernel launch for all chains, and the
one-shot potential value plus gradient used at chain init; a
conditionally separable potential (``CondPotentialSpec``) runs the same
entry points as plain torch."""
from repro_torch.kernels.fused_leapfrog.ops import (  # noqa: F401
    LAUNCHES, fused_leapfrog, potential_value_and_grad, reset_launch_counts)
from repro_torch.kernels.fused_leapfrog.spec import (  # noqa: F401
    N_OPS, OP_EXP, OP_NORMAL, OP_SOFTPLUS, OP_TLOG, OP_ZERO,
    CondPotentialSpec, PotentialSpec, cond_potential_value_and_grad,
    potential_elem_grad, potential_elem_value)
