"""PyTorch port: fused_logpdf ``site_block_sum`` and its autograd Functions.

Inputs come from a NumPy seed and go through the JAX package's
``site_block_sum`` (through its plain reference, ``use_pallas=False``:
the JAX package's own tests hold its Pallas kernels to that reference) and
per-array functions (its Pallas kernels in interpret mode) and the
port's, for all eight families.
Tolerances: value rtol 1e-5; gradient rtol 1e-5 with atol 1e-5 * max|g|
(float32 sums taken in a different order). The CUDA kernels themselves
run only on a GPU: ``test_torch_kernels_cuda.py`` holds them.
"""
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_logpdf import ops as jops
from repro_torch.kernels import _build
from repro_torch.kernels.fused_logpdf import ops, ref
from _jax_reference import _reference_compiled_unoptimised  # noqa: F401


SIZES = [[1], [255, 257], [1000, 129, 1]]
N_CLASSES = 7  # categorical segments: (n, C) logits and (n,) labels
MVN_D = 6      # mvnormal_prec segments: (n, D) centred rows, (D, D) precision
FAMILIES = ["std_normal", "normal", "bernoulli_logits", "categorical_logits",
            "gamma", "beta", "student_t", "mvnormal_prec"]
# the float columns of each family's segments (the labels get no gradient)
DIFF_COLS = {"std_normal": (0,), "normal": (0, 1, 2),
             "bernoulli_logits": (0, 1), "categorical_logits": (0,),
             "gamma": (0, 1, 2), "beta": (0, 1, 2), "student_t": (0, 1),
             "mvnormal_prec": (0, 1)}
PLAIN = {"std_normal": ref.std_normal_logpdf_sum_ref,
         "normal": ref.normal_logpdf_sum_ref,
         "bernoulli_logits": ref.bernoulli_logits_logpmf_sum_ref,
         "categorical_logits": ref.categorical_logits_logpmf_sum_ref,
         "gamma": ref.gamma_unnorm_logpdf_sum_ref,
         "beta": ref.beta_unnorm_logpdf_sum_ref,
         "student_t": ref.student_t_unnorm_logpdf_sum_ref,
         "mvnormal_prec": ref.mvnormal_prec_quadform_sum_ref}


def _precision(rng, d):
    a = rng.normal(0.0, 0.3, size=(d, d))
    return (a @ a.T + np.eye(d)).astype(np.float32)


def _segments(family, sizes, seed=0):
    rng = np.random.default_rng(seed)
    segs = []
    for n in sizes:
        if family == "mvnormal_prec":
            segs.append((rng.normal(size=(n, MVN_D)).astype(np.float32),
                         _precision(rng, MVN_D)))
            continue
        uniform = {"normal": ((-2.0, 2.0), (-1.0, 1.0), (0.3, 3.0)),
                   "beta": ((0.02, 0.98), (-0.5, 3.0), (-0.5, 3.0)),
                   "student_t": ((-6.0, 6.0), (0.5, 30.0))}
        if family in uniform:
            segs.append(tuple(rng.uniform(lo, hi, size=n).astype(np.float32)
                              for lo, hi in uniform[family]))
            continue
        if family == "categorical_logits":
            logits = rng.normal(0.0, 2.0, size=(n, N_CLASSES))
            labels = rng.integers(0, N_CLASSES, size=n).astype(np.int32)
            segs.append((logits.astype(np.float32), labels))
            continue
        if family == "gamma":
            segs.append(tuple(rng.uniform(lo, hi, size=n).astype(np.float32)
                              for lo, hi in ((0.05, 4.0), (-0.5, 3.0),
                                             (0.2, 3.0))))
            continue
        logits = rng.normal(0.0, 2.0, size=n).astype(np.float32)
        if family == "std_normal":
            segs.append((logits,))
        else:
            y = (rng.random(n) < 0.5).astype(np.float32)
            segs.append((logits, y))
    return segs


def _assert_grad_close(got, want):
    want = np.asarray(want)
    atol = 1e-5 * max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=atol)


@functools.lru_cache(maxsize=None)
def _jax_block_sums():
    """The JAX package's ``site_block_sum`` (plain reference) and its
    gradient in the float columns, for every family and ``SIZES`` entry,
    as one compiled program: the same arithmetic as op-by-op dispatch, in
    one compile for the module."""
    cases = [(family, tuple(sizes)) for family in FAMILIES for sizes in SIZES]

    def one(family, segs, floats):
        diff = DIFF_COLS[family]
        ss = [tuple(f[diff.index(i)] if i in diff else jnp.asarray(a)
                    for i, a in enumerate(s)) for s, f in zip(segs, floats)]
        return jops.site_block_sum(family, ss, use_pallas=False)

    segs = {c: _segments(c[0], c[1]) for c in cases}
    floats = [[tuple(jnp.asarray(s[i]) for i in DIFF_COLS[c[0]])
               for s in segs[c]] for c in cases]
    out = jax.jit(lambda fl: [
        jax.value_and_grad(functools.partial(one, c[0], segs[c]))(f)
        for c, f in zip(cases, fl)])(floats)
    return dict(zip(cases, out))


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("sizes", SIZES, ids=lambda s: "x".join(map(str, s)))
def test_site_block_sum_matches_jax_pallas_and_ref(family, sizes):
    segs = _segments(family, sizes)
    diff = DIFF_COLS[family]
    jval, jgrads = _jax_block_sums()[family, tuple(sizes)]
    tsegs = [tuple(torch.tensor(a, requires_grad=i in diff)
                   for i, a in enumerate(s)) for s in segs]
    val = ops.site_block_sum(family, tsegs)
    val.backward()
    val = val.detach()
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-5)
    for tseg, jseg in zip(tsegs, jgrads):
        for i, j in zip(diff, jseg):
            _assert_grad_close(tseg[i].grad.numpy(), j)
    # the plain version over the concatenated block (per segment for
    # mvnormal_prec, whose segments keep their own precision) agrees too
    if family == "mvnormal_prec":
        plain = sum(float(PLAIN[family](*map(torch.tensor, sg)))
                    for sg in segs)
    else:
        cols = [torch.tensor(np.concatenate(c)) for c in zip(*segs)]
        plain = float(PLAIN[family](*cols))
    np.testing.assert_allclose(float(val), plain, rtol=1e-5)


def _rel(a, b):
    """The JAX package's ``tests/test_kernel_families.py`` measure."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b) / (1.0 + np.abs(b)))


def _kernel_family_inputs(family):
    """The inputs of ``tests/test_kernel_families.py`` for each new family
    (N = 4,096; mvn 96 x 24), drawn from a NumPy seed."""
    rng = np.random.default_rng(42)
    n = 4096
    if family == "normal":
        return (rng.normal(size=n).astype(np.float32), np.float32(0.3),
                np.float32(1.7))
    if family == "beta":
        x = 1.0 / (1.0 + np.exp(-rng.normal(size=n)))
        return (x.astype(np.float32),
                rng.uniform(0.2, 3.0, n).astype(np.float32),
                rng.uniform(0.2, 3.0, n).astype(np.float32))
    if family == "student_t":
        return ((2.0 * rng.normal(size=n)).astype(np.float32),
                rng.uniform(2.0, 30.0, n).astype(np.float32))
    return (rng.normal(size=(96, 24)).astype(np.float32),
            _precision(rng, 24))


JAX_OPS = {"normal": jops.normal_logpdf_sum,
           "beta": jops.beta_unnorm_logpdf_sum,
           "student_t": jops.student_t_unnorm_logpdf_sum,
           "mvnormal_prec": jops.mvnormal_prec_quadform_sum}
TORCH_OPS = {"normal": ops.normal_logpdf_sum,
             "beta": ops.beta_unnorm_logpdf_sum,
             "student_t": ops.student_t_unnorm_logpdf_sum,
             "mvnormal_prec": ops.mvnormal_prec_quadform_sum}


@pytest.mark.parametrize("family", list(JAX_OPS))
def test_new_family_sums_and_grads_match_jax_pallas(family):
    """Each new family's per-array function against the JAX package's
    Pallas kernel in interpret mode, value and gradient in every float
    input, at that file's 1e-5."""
    args = _kernel_family_inputs(family)
    wrt = tuple(range(len(args)))
    jfun = JAX_OPS[family]
    jval, jgrads = jax.jit(jax.value_and_grad(
        lambda *a: jfun(*a, interpret=True), argnums=wrt))(
        *map(jnp.asarray, args))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    val = TORCH_OPS[family](*targs)
    val.backward()
    assert _rel(float(val.detach()), float(jval)) < 1e-5
    for t, jg in zip(targs, jgrads):
        assert _rel(t.grad.numpy(), jg) < 1e-5


def test_std_normal_vmap_grad_matches_loop_over_chains():
    z = torch.tensor(np.random.default_rng(1).normal(size=(4, 300)),
                     dtype=torch.float32)
    f = ops.std_normal_logpdf_sum
    g_v, v_v = torch.func.vmap(torch.func.grad_and_value(f))(z)
    for b in range(4):
        g_b, v_b = torch.func.grad_and_value(f)(z[b])
        np.testing.assert_allclose(float(v_v[b]), float(v_b), rtol=1e-6)
        np.testing.assert_allclose(g_v[b].numpy(), g_b.numpy(), rtol=1e-6)
    np.testing.assert_allclose(g_v.numpy(), -z.numpy(), rtol=1e-6)


@pytest.mark.parametrize("y_batched", [False, True],
                         ids=["shared_y", "batched_y"])
def test_bernoulli_vmap_grad_matches_loop_over_chains(y_batched):
    rng = np.random.default_rng(2)
    logits = torch.tensor(rng.normal(size=(3, 257)), dtype=torch.float32)
    y = torch.tensor((rng.random((3, 257) if y_batched else 257) < 0.5),
                     dtype=torch.float32)
    f = ops.bernoulli_logits_logpmf_sum
    in_dims = (0, 0 if y_batched else None)
    g_v, v_v = torch.func.vmap(torch.func.grad_and_value(f),
                               in_dims=in_dims)(logits, y)
    for b in range(3):
        yb = y[b] if y_batched else y
        g_b, v_b = torch.func.grad_and_value(f)(logits[b], yb)
        np.testing.assert_allclose(float(v_v[b]), float(v_b), rtol=1e-6)
        np.testing.assert_allclose(g_v[b].numpy(), g_b.numpy(), rtol=1e-6)
    want = (y - torch.sigmoid(logits)).numpy()
    np.testing.assert_allclose(g_v.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("labels_batched", [False, True],
                         ids=["shared_labels", "batched_labels"])
def test_categorical_vmap_grad_matches_loop_over_chains(labels_batched):
    rng = np.random.default_rng(3)
    logits = torch.tensor(rng.normal(0.0, 2.0, size=(3, 129, 5)),
                          dtype=torch.float32)
    labels = torch.tensor(rng.integers(0, 5, size=(3, 129) if labels_batched
                                       else 129), dtype=torch.int32)
    f = ops.categorical_logits_logpmf_sum
    in_dims = (0, 0 if labels_batched else None)
    g_v, v_v = torch.func.vmap(torch.func.grad_and_value(f),
                               in_dims=in_dims)(logits, labels)
    for b in range(3):
        lb = labels[b] if labels_batched else labels
        g_b, v_b = torch.func.grad_and_value(f)(logits[b], lb)
        np.testing.assert_allclose(float(v_v[b]), float(v_b), rtol=1e-6)
        np.testing.assert_allclose(g_v[b].numpy(), g_b.numpy(), rtol=1e-6)
    onehot = torch.nn.functional.one_hot(
        labels.long().expand(3, 129), 5).float()
    want = (onehot - torch.softmax(logits, dim=-1)).numpy()
    np.testing.assert_allclose(g_v.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("params_batched", [False, True],
                         ids=["shared_params", "batched_params"])
def test_gamma_vmap_grad_matches_loop_over_chains(params_batched):
    rng = np.random.default_rng(4)
    shape = (3, 257) if params_batched else (257,)
    x = torch.tensor(rng.uniform(0.05, 4.0, size=(3, 257)),
                     dtype=torch.float32)
    am1 = torch.tensor(rng.uniform(-0.5, 3.0, size=shape), dtype=torch.float32)
    rate = torch.tensor(rng.uniform(0.2, 3.0, size=shape), dtype=torch.float32)
    f = ops.gamma_unnorm_logpdf_sum
    d = 0 if params_batched else None
    g_v, v_v = torch.func.vmap(torch.func.grad_and_value(f),
                               in_dims=(0, d, d))(x, am1, rate)
    for b in range(3):
        ab, rb = (am1[b], rate[b]) if params_batched else (am1, rate)
        g_b, v_b = torch.func.grad_and_value(f)(x[b], ab, rb)
        np.testing.assert_allclose(float(v_v[b]), float(v_b), rtol=1e-6)
        np.testing.assert_allclose(g_v[b].numpy(), g_b.numpy(), rtol=1e-6)
    np.testing.assert_allclose(g_v.numpy(), (am1 / x - rate).numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("family", ["normal", "beta", "student_t"])
@pytest.mark.parametrize("params_batched", [False, True],
                         ids=["shared_params", "batched_params"])
def test_new_elementwise_vmap_grad_matches_loop_over_chains(family,
                                                            params_batched):
    (x, *params), = _segments(family, [3 * 257], seed=5)
    x = torch.tensor(x.reshape(3, 257))
    params = [torch.tensor(p.reshape(3, 257) if params_batched
                           else p[:257]) for p in params]
    f = TORCH_OPS[family]
    d = 0 if params_batched else None
    in_dims = (0,) + (d,) * len(params)
    g_v, v_v = torch.func.vmap(torch.func.grad_and_value(f),
                               in_dims=in_dims)(x, *params)
    for b in range(3):
        pb = [p[b] for p in params] if params_batched else params
        g_b, v_b = torch.func.grad_and_value(f)(x[b], *pb)
        np.testing.assert_allclose(float(v_v[b]), float(v_b), rtol=1e-6)
        np.testing.assert_allclose(g_v[b].numpy(), g_b.numpy(), rtol=1e-6)


def test_normal_vmap_per_chain_scalars_beside_shared_data():
    """gauss_unknown's per-array route: shared data x (n,) and one mu and
    one sigma per chain; the gradients in mu and sigma sum over x."""
    rng = np.random.default_rng(6)
    x = torch.tensor(rng.normal(1.5, 0.7, size=2000), dtype=torch.float32)
    mu = torch.tensor([1.0, 1.5, 2.0, -0.5])
    sig = torch.tensor([0.5, 0.7, 1.0, 2.0])
    f = ops.normal_logpdf_sum
    g_v, v_v = torch.func.vmap(torch.func.grad_and_value(f, argnums=(1, 2)),
                               in_dims=(None, 0, 0))(x, mu, sig)
    for b in range(4):
        want = torch.distributions.Normal(mu[b], sig[b]).log_prob(x).sum()
        np.testing.assert_allclose(float(v_v[b]), float(want), rtol=1e-5)
        z = (x - mu[b]) / sig[b]
        np.testing.assert_allclose(float(g_v[0][b]), float((z / sig[b]).sum()),
                                   rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(float(g_v[1][b]),
                                   float(((z * z - 1) / sig[b]).sum()),
                                   rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("prec_batched", [False, True],
                         ids=["shared_prec", "per_chain_prec"])
def test_mvn_vmap_grad_matches_loop_over_chains(prec_batched):
    rng = np.random.default_rng(7)
    xc = torch.tensor(rng.normal(size=(3, 10, 5)), dtype=torch.float32)
    precs = np.stack([_precision(rng, 5) for _ in range(3)])
    prec = torch.tensor(precs if prec_batched else precs[0])
    f = ops.mvnormal_prec_quadform_sum
    d = 0 if prec_batched else None
    g_v, v_v = torch.func.vmap(torch.func.grad_and_value(f, argnums=(0, 1)),
                               in_dims=(0, d))(xc, prec)
    for b in range(3):
        pb = prec[b] if prec_batched else prec
        g_b, v_b = torch.func.grad_and_value(f, argnums=(0, 1))(xc[b], pb)
        np.testing.assert_allclose(float(v_v[b]), float(v_b), rtol=1e-6)
        np.testing.assert_allclose(g_v[0][b].numpy(), g_b[0].numpy(),
                                   rtol=1e-5, atol=1e-6)
    if not prec_batched:  # the shared precision's gradient sums the chains
        want = sum(torch.func.grad(f, argnums=1)(xc[b], prec)
                   for b in range(3))
        np.testing.assert_allclose(g_v[1].sum(0).numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_categorical_plain_version_edges():
    """What the kernel must give at the edges, as the plain version defines
    it: a label outside [0, C) gives NaN; a -inf logit adds nothing to the
    normaliser; a row of -inf logits gives NaN."""
    ninf = float("-inf")
    logits = torch.tensor([[[0.0, ninf, 1.0], [2.0, 0.5, -1.0]]])
    got = ref.categorical_logits_logpmf_sum_ref(
        logits, torch.tensor([[0, 1]], dtype=torch.int32))
    want = torch.log_softmax(torch.tensor([0.0, 1.0]), -1)[0] \
        + torch.log_softmax(logits[0, 1], -1)[1]
    torch.testing.assert_close(got, want.reshape(1))
    assert ref.categorical_logits_logpmf_sum_ref(
        logits, torch.tensor([1, 0], dtype=torch.int32)).item() == ninf
    for bad in (-1, 3, 7):
        lab = torch.tensor([0, bad], dtype=torch.int32)
        assert torch.isnan(ref.categorical_logits_logpmf_sum_ref(logits, lab))
    allninf = torch.full((1, 2, 3), ninf)
    assert torch.isnan(ref.categorical_logits_logpmf_sum_ref(
        allninf, torch.tensor([0, 2], dtype=torch.int32)))


def test_row_wrappers_run_plain_version_on_cpu_without_counting():
    ops.reset_launch_counts()
    z = torch.randn(4, 101)
    np.testing.assert_array_equal(ops.std_normal_sum_rows(z).numpy(),
                                  ref.std_normal_logpdf_sum_ref(z).numpy())
    logits = torch.randn(4, 100)
    y = (torch.rand(100) < 0.5).float().expand(4, 100)  # row stride 0
    np.testing.assert_array_equal(
        ops.bernoulli_logit_sum_rows(logits, y).numpy(),
        ref.bernoulli_logits_logpmf_sum_ref(logits, y).numpy())
    for c in (5, 257):  # the small-C path's classes, and the large path's
        cat = torch.randn(4, 100, c)
        labels = torch.randint(0, c, (100,), dtype=torch.int32).expand(4, 100)
        np.testing.assert_array_equal(
            ops.categorical_logits_sum_rows(cat, labels).numpy(),
            ref.categorical_logits_logpmf_sum_ref(cat, labels).numpy())
    yv = torch.tensor([[0.0], [1.0], [1.0], [0.0]]).expand(4, 100)
    np.testing.assert_array_equal(  # one y a row (element stride 0)
        ops.bernoulli_logit_sum_rows(logits, yv).numpy(),
        ref.bernoulli_logits_logpmf_sum_ref(logits, yv).numpy())
    x = torch.rand(4, 100) + 0.1
    a = torch.full((100,), 0.5).expand(4, 100)
    np.testing.assert_array_equal(
        ops.gamma_unnorm_sum_rows(x, a, a).numpy(),
        ref.gamma_unnorm_logpdf_sum_ref(x, a, a).numpy())
    s = torch.tensor([[0.5], [1.0], [2.0], [3.0]]).expand(4, 100)  # stride 0
    np.testing.assert_array_equal(
        ops.normal_sum_rows(x, a, s).numpy(),
        ref.normal_logpdf_sum_ref(x, a, s).numpy())
    xb = x / 1.2
    np.testing.assert_array_equal(
        ops.beta_unnorm_sum_rows(xb, a, a).numpy(),
        ref.beta_unnorm_logpdf_sum_ref(xb, a, a).numpy())
    np.testing.assert_array_equal(
        ops.student_t_unnorm_sum_rows(logits, s).numpy(),
        ref.student_t_unnorm_logpdf_sum_ref(logits, s).numpy())
    xc = torch.randn(4, 30, 6)
    prec = torch.eye(6).expand(4, 6, 6)  # one precision for every row
    np.testing.assert_array_equal(
        ops.mvn_quadform_sum_rows(xc, prec).numpy(),
        ref.mvnormal_prec_quadform_sum_ref(xc, prec).numpy())
    assert ops.LAUNCHES == dict.fromkeys(
        ("std_normal_sum", "bernoulli_logit_sum", "categorical_logits_sum",
         "categorical_logits_sum_small", "gamma_unnorm_sum", "normal_sum",
         "beta_unnorm_sum", "student_t_unnorm_sum", "mvn_quadform_sum"), 0)


def test_row_wrappers_reject_what_the_kernel_cannot_take():
    with pytest.raises(TypeError):
        ops.std_normal_sum_rows(torch.zeros(2, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="inner stride"):
        ops.std_normal_sum_rows(torch.zeros(8, 2).t())
    with pytest.raises(ValueError, match="device"):
        ops.std_normal_sum_rows(torch.zeros(2, 8, device="meta"))
    with pytest.raises(ValueError, match="shape"):
        ops.bernoulli_logit_sum_rows(torch.zeros(2, 8), torch.zeros(2, 7))
    with pytest.raises(TypeError, match="int32"):
        ops.categorical_logits_sum_rows(torch.zeros(2, 8, 3),
                                        torch.zeros(2, 8, dtype=torch.int64))
    with pytest.raises(ValueError, match="strides"):
        ops.categorical_logits_sum_rows(torch.zeros(2, 3, 8).transpose(1, 2),
                                        torch.zeros(2, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="shape"):
        ops.gamma_unnorm_sum_rows(torch.ones(2, 8), torch.ones(2, 8),
                                  torch.ones(1, 8))
    with pytest.raises(ValueError, match="element stride"):
        ops.normal_sum_rows(torch.ones(2, 8), torch.ones(8, 2).t(),
                            torch.ones(2, 8))
    with pytest.raises(TypeError):
        ops.student_t_unnorm_sum_rows(torch.ones(2, 8),
                                      torch.ones(2, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="prec"):
        ops.mvn_quadform_sum_rows(torch.ones(2, 8, 3), torch.ones(2, 4, 4))
    with pytest.raises(ValueError, match="strides"):
        ops.mvn_quadform_sum_rows(torch.ones(2, 3, 8).transpose(1, 2),
                                  torch.ones(2, 3, 3))


def test_site_block_sum_families():
    assert float(ops.site_block_sum("std_normal", [])) == 0.0
    with pytest.raises(ValueError):
        ops.site_block_sum("poisson", [(torch.zeros(3),)])
    # every family of the JAX package has its kernel: beta at x = 1/2 with
    # a - 1 = b - 1 = 0 sums to zero
    assert set(ops.SITE_BLOCK_FAMILIES) == set(jops.SITE_BLOCK_FAMILIES)
    assert float(ops.site_block_sum("beta", [(torch.full((3,), 0.5),
                                              torch.zeros(3),
                                              torch.zeros(3))])) == 0.0


def test_build_fails_loudly_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "_DEFAULT_NVCC", tmp_path / "no-nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library(ops.kernel_source())


def test_library_path_is_keyed_by_source_content(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    src = tmp_path / "k.cu"
    src.write_text("// a")
    a = _build.library_path(src)
    assert a == _build.library_path(src)
    src.write_text("// b")
    assert _build.library_path(src) != a
    assert a.name == "libk.so" and a.parent.parent == tmp_path


def test_library_path_is_keyed_by_included_headers(tmp_path, monkeypatch):
    """An edit of a header the source includes by a quoted path rebuilds;
    the three 3xTF32 sources share kernels/csrc/tf32.cuh."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    (tmp_path / "inc").mkdir()
    (tmp_path / "k").mkdir()
    head = tmp_path / "inc" / "h.cuh"
    head.write_text("// a")
    src = tmp_path / "k" / "k.cu"
    src.write_text('#include <stdint.h>\n  #include "../inc/h.cuh"\n')
    assert _build.source_files(src) == [src.resolve(), head.resolve()]
    a = _build.library_path(src)
    head.write_text("// b")
    assert _build.library_path(src) != a
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_scan import ops as sops
    tf32 = Path(_build.__file__).resolve().parent / "csrc" / "tf32.cuh"
    for source in (fops.kernel_source(), sops.kernel_source(),
                   ops.mvn_kernel_source()):
        assert _build.source_files(source) == [source, tf32]
    assert _build.source_files(ops.kernel_source()) == [ops.kernel_source()]


# each per-array function, its autograd Function, and its inputs (1-D, or
# (N, C) logits and (N, D) centred rows)
PER_ARRAY = {
    "std_normal_logpdf_sum": ("_StdNormalSum", ("z",)),
    "normal_logpdf_sum": ("_NormalSum", ("x", "loc", "scale")),
    "bernoulli_logits_logpmf_sum": ("_BernoulliLogitSum", ("l", "y")),
    "categorical_logits_logpmf_sum": ("_CategoricalLogitsSum",
                                      ("logits", "labels")),
    "gamma_unnorm_logpdf_sum": ("_GammaUnnormSum", ("x", "am1", "rate")),
    "beta_unnorm_logpdf_sum": ("_BetaUnnormSum", ("u", "am1", "bm1")),
    "student_t_unnorm_logpdf_sum": ("_StudentTUnnormSum", ("z", "df")),
    "mvnormal_prec_quadform_sum": ("_MvnQuadformSum", ("xc", "prec")),
}


def _per_array_inputs(seed=9, n=300):
    rng = np.random.default_rng(seed)
    return {"z": rng.normal(size=n), "x": rng.uniform(0.2, 3.0, n),
            "loc": rng.normal(size=n), "scale": rng.uniform(0.5, 2.0, n),
            "l": rng.normal(size=n), "y": (rng.uniform(size=n) < 0.4) * 1.0,
            "logits": rng.normal(size=(n, 5)),
            "labels": rng.integers(0, 5, n).astype(np.int32),
            "am1": rng.uniform(-0.5, 2.0, n), "rate": rng.uniform(0.5, 2, n),
            "u": rng.uniform(0.05, 0.95, n), "bm1": rng.uniform(-0.5, 2, n),
            "df": rng.uniform(1.0, 9.0, n),
            "xc": rng.normal(size=(n, MVN_D)), "prec": _precision(rng, MVN_D)}


def _as(t, v, torch_side):
    if v.dtype == np.int32:
        return torch.as_tensor(v) if torch_side else jnp.asarray(v)
    v = v.astype(np.float32)
    return torch.as_tensor(v) if torch_side else jnp.asarray(v)


@functools.lru_cache(maxsize=None)
def _jax_per_array():
    """Each per-array function of the JAX package on
    ``_per_array_inputs()``, its Pallas kernel in interpret mode, all in
    one compiled program."""
    ins = _per_array_inputs()
    names = sorted(PER_ARRAY)
    args = [[_as(None, ins[c], False) for c in PER_ARRAY[n][1]]
            for n in names]
    out = jax.jit(lambda args: [
        getattr(jops, n)(*a, block_rows=8, interpret=True)
        for n, a in zip(names, args)])(args)
    return dict(zip(names, out))


@pytest.mark.parametrize("name", sorted(PER_ARRAY))
def test_per_array_functions_take_the_jax_keywords(name, monkeypatch):
    """block_rows is accepted and ignored; interpret=True runs the plain
    version (never the kernel's autograd Function) and equals the JAX
    package's Pallas kernel in interpret mode."""
    fn_cls, cols = PER_ARRAY[name]
    ins = _per_array_inputs()
    want = _jax_per_array()[name]
    t_ins = [_as(None, ins[c], True) for c in cols]
    fn = getattr(ops, name)
    default = fn(*t_ins, block_rows=8)
    ops.reset_launch_counts()

    def kernel_route(*args, **kw):
        raise AssertionError(f"{fn_cls} ran under interpret=True")

    monkeypatch.setattr(getattr(ops, fn_cls), "apply", kernel_route)
    got = fn(*t_ins, block_rows=8, interpret=True)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(got) == float(default)
    assert sum(ops.LAUNCHES.values()) == 0
    with pytest.raises(AssertionError, match="ran under"):
        fn(*t_ins, interpret=None)  # the default keeps the kernel route


@functools.lru_cache(maxsize=None)
def _jax_block_sum_plain():
    """The JAX package's ``site_block_sum`` through its plain reference on
    ``_segments(family, [129, 3])`` for every family, one compiled
    program for the module."""
    segs = {f: [tuple(jnp.asarray(c) for c in s)
                for s in _segments(f, [129, 3])] for f in FAMILIES}
    out = jax.jit(lambda segs: {f: jops.site_block_sum(
        f, segs[f], use_pallas=False) for f in FAMILIES})(segs)
    return {f: float(v) for f, v in out.items()}


@pytest.mark.parametrize("switch", [dict(use_pallas=False),
                                    dict(interpret=True),
                                    dict(use_pallas=True, interpret=True)])
@pytest.mark.parametrize("family", FAMILIES)
def test_site_block_sum_takes_the_jax_switches(family, switch, monkeypatch):
    segs = _segments(family, [129, 3])
    want = _jax_block_sum_plain()[family]
    t_segs = [tuple(torch.as_tensor(c) for c in s) for s in segs]
    for fn_cls, _ in PER_ARRAY.values():
        monkeypatch.setattr(getattr(ops, fn_cls), "apply",
                            lambda *a, **k: pytest.fail("kernel route"))
    got = ops.site_block_sum(family, t_segs, **switch)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_categorical_group_by_class_count():
    """Lanes per item: the smallest group holding at most 8 classes a
    lane, none (one warp per item) above 256 classes."""
    want = {1: 4, 3: 4, 4: 4, 5: 4, 20: 4, 32: 4, 33: 8, 64: 8, 65: 16,
            99: 16, 100: 16, 128: 16, 129: 32, 256: 32, 257: 0, 50_280: 0}
    assert {c: ops.categorical_group(c) for c in want} == want
    assert ops.SMALL_C == 256
    for c in range(1, 300):
        g = ops.categorical_group(c)
        assert (g == 0) == (c > ops.SMALL_C)
        assert g == 0 or -(-c // g) <= 8


def _tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero: ``cvt.rna.tf32.f32``. The sign-magnitude bits take the
    half unit of the dropped 13 bits, then lose them."""
    bits = a.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    sign = bits & 0x80000000
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    out = (sign | mag) - ((sign | mag) >> 31 << 32)  # back to signed 32-bit
    return out.to(torch.int32).view(torch.float32)


def _tf32_trunc(a: torch.Tensor) -> torch.Tensor:
    """float32 as the TF32 mma reads it: the low 13 bits dropped."""
    return (a.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mvn_3xtf32_emulation(xc: torch.Tensor, prec: torch.Tensor
                          ) -> torch.Tensor:
    """``mvn_quad.cu``'s arithmetic in plain torch: each operand split into
    a TF32 high part (rounded) and the rest (as the mma reads it:
    truncated to TF32), (xc P^T) taken as lo hi + hi lo + hi hi in float32
    (the kernel reads P's rows: the form is the same for P and P^T), then
    -1/2 sum(xc P^T o xc)."""
    pt = prec.mT
    xh, ph = _tf32_rna(xc), _tf32_rna(pt)
    xl, pl = _tf32_trunc(xc - xh), _tf32_trunc(pt - ph)
    xp = xl @ ph + xh @ pl + xh @ ph
    return -0.5 * (xp * xc).sum(dim=(-2, -1))


def test_tf32_rounding_keeps_ten_mantissa_bits():
    a = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 3.0, 2.0 ** -30, 1.0 - 2.0 ** -12],
                     dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                         -(1.0 + 2.0 ** -10), 3.0, 2.0 ** -30, 1.0],
                        dtype=torch.float32)
    assert torch.equal(_tf32_rna(a), want)
    x = torch.randn(1000)
    hi = _tf32_rna(x)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((x - hi).abs() / x.abs()).max()) <= 2.0 ** -11


@pytest.mark.parametrize("d", [5, 64, 256])
def test_mvn_3xtf32_emulation_matches_jax_at_rtol_1e5(d):
    """The kernel's 3xTF32 rounding, emulated in plain torch, against the
    JAX package's mvnormal_prec_quadform_sum (its Pallas kernel in
    interpret mode) on the same NumPy inputs, at the chip gate's rtol
    1e-5; a single TF32 product lands further off (1e-5 to 3e-5 here),
    which is what the low parts are for."""
    rng = np.random.default_rng(d)
    xc = rng.normal(size=(96, d)).astype(np.float32)
    a = rng.normal(size=(d, d)) / np.sqrt(d)
    prec = (a @ a.T + np.eye(d)).astype(np.float32)
    want = float(jops.mvnormal_prec_quadform_sum(jnp.asarray(xc),
                                                 jnp.asarray(prec)))
    xt, pt = torch.as_tensor(xc)[None], torch.as_tensor(prec)[None]
    got = float(_mvn_3xtf32_emulation(xt, pt)[0])
    assert abs(got - want) <= 1e-5 * abs(want)
    one_pass = float(-0.5 * ((_tf32_rna(xt) @ _tf32_rna(pt)) * xt).sum())
    assert abs(one_pass - want) > abs(got - want)


def test_mvn_tiles_and_shared_memory():
    """mvn_quad.cu's tiling (128 rows by 128 columns of P, 64 when D <= 64)
    and its three-stage ring: two blocks fit on an SM (228 KB, 1 KB kept
    per block) at every width, so 4 x 4,096 x 256 is one wave."""
    assert ops.mvn_tiles(1, 5) == 1
    assert ops.mvn_tiles(4096, 256) == 32 * 2
    assert ops.mvn_tiles(100_000, 1024) == 782 * 8
    assert ops.mvn_tiles(129, 65) == 2 * 1
    for d in (1, 5, 64, 65, 256, 1024):
        smem = ops.mvn_smem_bytes(d)
        assert smem <= ops.MAX_SMEM_BYTES
        assert 2 * (smem + 1024) <= 228 * 1024
    assert ops.mvn_smem_bytes(256) == 3 * (128 + 128) * 36 * 4
    assert 4 * ops.mvn_tiles(4096, 256) <= 2 * 132


# reduce_plan's inputs: (address in bytes, row stride in floats)
ALIGNED, UNALIGNED = 0x7F00_0000_0200, 0x7F00_0000_0204  # a z[:, 1:] view


@pytest.mark.parametrize("n,nparts", [
    (1, 1), (ops.REDUCE_SHARE, 1), (ops.REDUCE_SHARE + 1, 2),
    (40_000, 20), (1_000_003, 489), (1024 * ops.REDUCE_SHARE, 1024),
    (1024 * ops.REDUCE_SHARE + 1, 1024)])
def test_reduce_plan_parts_from_n_alone(n, nparts):
    """One block a row up to the share (it writes out[b] itself), then one
    block per 2,048 floats up to 1,024 (rounds beyond); the inputs' layout
    never changes the parts."""
    for inputs in ((), ((ALIGNED, n),), ((UNALIGNED, n + 1), (ALIGNED, 0))):
        assert ops.reduce_plan(n, inputs).nparts == nparts


@pytest.mark.parametrize("inputs,vec", [
    (((ALIGNED, 40_000),), True),             # dense rows, n % 4 == 0
    (((ALIGNED, 0),), True),                  # one row shared (stride 0)
    (((UNALIGNED, 40_001),), False),          # a z[:, 1:] view
    (((ALIGNED, 101),), False),               # n = 101: rows drift off 16 B
    (((ALIGNED, 400), (ALIGNED, 0), (ALIGNED, 0)), True),  # gamma, shared
    (((ALIGNED, 400), (ALIGNED + 4, 0), (ALIGNED, 0)), False),
    ((), True)])
def test_reduce_plan_loads_from_alignment(inputs, vec):
    assert ops.reduce_plan(400, inputs).vec is vec


@pytest.mark.parametrize("rows", [1, 4, 65535])
@pytest.mark.parametrize("n", [1, 2048, 2049, 1_000_003])
def test_reduce_scratch_never_exceeds_rows_times_parts(rows, n):
    plan = ops.reduce_plan(n)
    need = ops.partials_needed(rows, plan)
    assert need <= rows * plan.nparts
    assert need == (0 if n <= ops.REDUCE_SHARE else rows * plan.nparts)


# beta's and student_t's inputs: (address, row stride, element stride); an
# element stride of 0 is one value a row, read once and never as a vector
PARTS_AT = {1: 1, 8: 1, 1024: 1, 2048: 1, 2049: 2, 40_000: 20}


@pytest.mark.parametrize("n", sorted(PARTS_AT))
@pytest.mark.parametrize("inputs,vec", [
    # dense rows beside a per-row scalar at any address (vmap's mu)
    (((ALIGNED, 40_000, 1), (UNALIGNED, 1, 0), (ALIGNED + 8, 1, 0)), True),
    # a shared row, and one value shared by every row
    (((ALIGNED, 40_000, 1), (ALIGNED, 0, 1), (UNALIGNED, 0, 0)), True),
    (((UNALIGNED, 40_000, 1), (ALIGNED, 1, 0)), False),  # a z[:, 1:] view
    (((ALIGNED, 40_000, 1), (UNALIGNED, 0, 1)), False),  # shared, off 16 B
    (((ALIGNED, 101, 1), (ALIGNED, 1, 0)), False),       # rows drift off
    (((UNALIGNED, 3, 0), (UNALIGNED + 4, 1, 0)), True),  # all one a row
    (((ALIGNED, 0), (UNALIGNED, 1, 0)), True)])          # both forms
def test_reduce_plan_element_strides(n, inputs, vec):
    """An element-stride-0 input never bars 16-byte loads; an unaligned
    dense one does; the parts come from n alone."""
    assert ops.reduce_plan(n, inputs) == ops.ReducePlan(PARTS_AT[n], vec)


def _family_rows(family, rows, n, layout):
    """CPU inputs of normal_sum, beta_unnorm_sum or student_t_unnorm_sum in
    the layouts the kernels take: x dense, or one float past a 16-byte boundary
    ("offset"); the parameters per row ("dense"), one row shared by every
    row ("shared", row stride 0) or one value a row ("scalar", element
    stride 0)."""
    if layout == "offset":
        x = torch.full((rows * n + 1,), 0.5)[1:].view(rows, n)
    else:
        x = torch.full((rows, n), 0.5)
    param = {"dense": lambda: torch.ones(rows, n),
             "offset": lambda: torch.ones(rows, n),
             "shared": lambda: torch.ones(n).expand(rows, n),
             "scalar": lambda: torch.ones(rows, 1).expand(rows, n)}[layout]
    if family in ("student_t", "bernoulli"):
        return x, param()
    return x, param(), param()


@pytest.mark.parametrize("family", ["beta", "student_t", "normal",
                                    "bernoulli"])
@pytest.mark.parametrize("layout", ["dense", "offset", "shared", "scalar"])
@pytest.mark.parametrize("rows,n", [(4, 1), (4, 8), (4, 1024), (4, 2048),
                                    (4, 2049), (4, 40_000), (1, 1_000_003)])
def test_partials_needed_for_beta_and_student_t(family, layout, rows, n):
    """The plan each wrapper takes from its inputs' layout, and the scratch
    a call needs: none up to one block's share of a row, one float a
    (row, part) beyond. Pure Python on CPU tensors (their addresses and
    strides are what the wrapper reads on the card)."""
    ins = _family_rows(family, rows, n, layout)
    inputs = ops._reduce_inputs(ins, rows, n, elem_strides=True)
    es = {"dense": 1, "offset": 1, "shared": 1, "scalar": 0}[layout]
    assert inputs[1][1:] == ((0 if layout == "shared" or rows == 1 else n
                              if es else 1), es if n > 1 else 0)
    plan = ops.reduce_plan(n, inputs)
    assert plan.nparts == -(-n // ops.REDUCE_SHARE)
    assert plan.vec == (n == 1 or (layout != "offset"
                                   and (rows == 1 or n % 4 == 0)))
    need = ops.partials_needed(rows, plan)
    assert need == (0 if n <= ops.REDUCE_SHARE else rows * plan.nparts)


@pytest.mark.parametrize("rows,n", [(4, 1), (4, 10_000), (4, 10_001),
                                    (4, 40_000)])
def test_normal_sum_plan_on_the_switch_route(rows, n):
    """gauss_unknown's switch route hands normal_sum the data shared by the
    chains (row stride 0) and one mu and one sigma a chain (element stride
    0): 16-byte loads at any n, as the shared row starts aligned and the
    per-chain values are read once a thread; parts from n alone."""
    x = torch.zeros(n).expand(rows, n)
    mu, sig = torch.zeros(rows, 1), torch.ones(rows, 1)
    ins = (x, mu.expand(rows, n), sig.expand(rows, n))
    inputs = ops._reduce_inputs(ins, rows, n, elem_strides=True)
    assert [t[1:] for t in inputs] == [(0, 1 if n > 1 else 0)] + \
        [(1, 0)] * 2
    plan = ops.reduce_plan(n, inputs)
    assert plan == ops.ReducePlan(-(-n // ops.REDUCE_SHARE), True)
    assert "normal_sum" in ops._ONE_LAUNCH


@pytest.mark.parametrize("rows,n", [(4, 1), (4, 10_000), (4, 40_000),
                                    (1, 1_000_003)])
def test_bernoulli_is_one_launch_on_logregs_layout(rows, n):
    """logreg hands bernoulli_logit_sum its logits a row per chain and y
    shared by the chains (row stride 0): 16-byte loads when the logits'
    rows start aligned, parts from n alone, row_sum's scratch; an offset
    view of the logits takes 4-byte loads."""
    assert "bernoulli_logit_sum" in ops._ONE_LAUNCH
    logits, y = torch.zeros(rows, n), torch.zeros(n).expand(rows, n)
    inputs = ops._reduce_inputs((logits, y), rows, n, elem_strides=True)
    es = 1 if n > 1 else 0
    assert [t[1:] for t in inputs] == [(n if rows > 1 else 0, es), (0, es)]
    plan = ops.reduce_plan(n, inputs)
    assert plan == ops.ReducePlan(-(-n // ops.REDUCE_SHARE), True)
    assert ops.partials_needed(rows, plan) == (
        0 if n <= ops.REDUCE_SHARE else rows * plan.nparts)
    off = torch.zeros(rows * n + 1)[1:].view(rows, n)
    inputs = ops._reduce_inputs((off, y), rows, n, elem_strides=True)
    assert ops.reduce_plan(n, inputs).vec is (n == 1)


@pytest.mark.parametrize("n,nparts", [
    (1, 1), (ops.CAT_ITEMS, 1), (ops.CAT_ITEMS + 1, 2), (99, 13),
    (8192, 1024), (1024 * ops.CAT_ITEMS + 1, 1024), (10 ** 6, 1024)])
@pytest.mark.parametrize("c", [257, 1000, 4097, 49_152, 50_280])
def test_categorical_plan_from_n_c_and_addresses(n, nparts, c):
    """The large-C categorical_logits_sum: ceil(n / CAT_ITEMS) blocks a row
    up to 1,024 (rounds beyond) from n alone, whatever the layout; 16-byte
    loads only when C is a multiple of 4 and the logits' rows start
    16-byte aligned (row stride 0 included); scratch as the reductions'."""
    assert ops.CAT_ITEMS == 8
    for addr, stride in ((ALIGNED, n * c), (ALIGNED, 0), (UNALIGNED, 0),
                         (ALIGNED, n * c + 1)):
        plan = ops.categorical_plan(n, c, addr, stride)
        assert plan.nparts == nparts
        assert plan.vec is (c % 4 == 0 and addr == ALIGNED
                            and stride % 4 == 0)
        for rows in (1, 4):
            assert ops.partials_needed(rows, plan) == (
                0 if nparts == 1 else rows * nparts)
