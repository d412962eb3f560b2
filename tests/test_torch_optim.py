"""PyTorch port: ``repro_torch.optim`` against ``repro.optim``.

Three steps of ``sgd`` with momentum, ``adam`` and ``adamw`` on the same
NumPy parameters and gradients (a tuple and a dict tree, so both tree
kinds are flattened), all of the JAX package's steps in one ``jax.jit``
program. Tolerance 1e-7, absolute and relative: both packages run the
same float32 expressions in the same order, so they agree to the last
bit or two. The optimiser states enter the JAX program as inputs: a step
count that XLA could constant-fold gives ``b2 ** 3`` one ulp off the
runtime ``pow`` that both packages run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro_torch import optim as toptim
from _jax_reference import _reference_compiled_unoptimised  # noqa: F401

STEPS = 3
MAKERS = {
    "sgd_momentum": lambda o: o.sgd(0.1, momentum=0.9),
    "adam": lambda o: o.adam(0.05),
    "adamw": lambda o: o.adamw(0.05),
}


def _inputs():
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(STEPS)]
    return params, grads


def _init(o, params, asarray):
    """Each optimiser's state for the dict tree and for a tuple tree."""
    p = {k: asarray(v) for k, v in params.items()}
    tup = (asarray(params["b"]),)  # a tuple tree beside the dict
    return {name: (make(o).init(p), make(o).init(tup))
            for name, make in MAKERS.items()}


def _run(o, params, grads, states, asarray):
    outs = {}
    for name, make in MAKERS.items():
        opt = make(o)
        p = {k: asarray(v) for k, v in params.items()}
        tup = (asarray(params["b"]),)
        state, tstate = states[name]
        for g in grads:
            gd = {k: asarray(v) for k, v in g.items()}
            deltas, state = opt.update(gd, state, p)
            p = o.apply_updates(p, deltas)
            tdeltas, tstate = opt.update((gd["b"],), tstate, tup)
            tup = o.apply_updates(tup, tdeltas)
        outs[name] = (p, tup)
    return outs


@pytest.fixture(scope="module")
def reference():
    """The JAX package's optimiser runs, global norm and clipping, in one
    jitted program."""
    params, grads = _inputs()
    want = jax.jit(lambda p, g, s: (
        _run(joptim, p, g, s, jnp.asarray),
        joptim.clip_by_global_norm(p, 1.0)))(
        params, grads, _init(joptim, params, jnp.asarray))
    return params, grads, jax.tree_util.tree_map(np.asarray, want)


@pytest.mark.parametrize("name", list(MAKERS))
def test_optimizers_match_the_reference(reference, name):
    params, grads, (want, _) = reference
    got = _run(toptim, params, grads, _init(toptim, params, torch.tensor),
               torch.tensor)[name]
    (wp, wtup) = want[name]
    for k in params:
        np.testing.assert_allclose(got[0][k].numpy(), wp[k], rtol=1e-7,
                                   atol=1e-7)
    np.testing.assert_allclose(got[1][0].numpy(), wtup[0], rtol=1e-7,
                               atol=1e-7)
    # the tuple tree ran the same arithmetic as the dict's "b" leaf
    np.testing.assert_array_equal(got[1][0].numpy(), got[0]["b"].numpy())


def test_global_norm_and_clipping_match_the_reference(reference):
    params, _, (_, (jclipped, jnorm)) = reference
    tree = {k: torch.tensor(v) for k, v in params.items()}
    clipped, norm = toptim.clip_by_global_norm(tree, 1.0)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    np.testing.assert_allclose(float(toptim.global_norm(tree)), float(jnorm),
                               rtol=1e-6)
    for k in params:
        np.testing.assert_allclose(clipped[k].numpy(), np.asarray(jclipped[k]),
                                   rtol=1e-6, atol=1e-7)
    assert float(toptim.global_norm({})) == 0.0
