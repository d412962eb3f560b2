"""Helpers shared by the port's tests (``tests/test_torch_*.py``) that hold
the port against the JAX package."""
import functools

import jax
import pytest


@pytest.fixture(scope="module", autouse=True)
def _reference_compiled_unoptimised():
    """The JAX package's programs in the importing module compiled with
    XLA's backend optimisations off (``jax_disable_most_optimizations``):
    the same HLO in less of the compile time that dominates these tests on
    the CPU; the setting is put back for the modules after this one."""
    prev = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)


@functools.lru_cache(maxsize=None)
def moe_ffn_reference(capacity_factor):
    """``repro.nn.moe.moe_ffn`` on ``_torch_dist.moe_case()``'s inputs: the
    output and the gradients of ``sum(y * w)`` (the params' leaves in
    sorted-key order, then x), as NumPy; compiled once a capacity for
    every module that asks."""
    import jax.numpy as jnp
    import numpy as np

    import _torch_dist
    from repro.nn import moe

    params, x, w = _torch_dist.moe_case()

    def loss(p, x):
        y = moe.moe_ffn(p, x, top_k=_torch_dist.MOE["top_k"],
                        capacity_factor=capacity_factor)
        return jnp.sum(y * w), y

    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    return (np.asarray(y), [np.asarray(g) for g in
                            jax.tree_util.tree_leaves(gp)] + [np.asarray(gx)])
