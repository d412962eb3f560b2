"""Helpers shared by the port's tests (``tests/test_torch_*.py``) that hold
the port against the JAX package."""
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
