"""PyTorch port: fused_logpdf ``site_block_sum`` and its autograd Functions.

Inputs come from a NumPy seed and go through the JAX package's
``site_block_sum`` (its Pallas kernels in interpret mode) and the port's.
Tolerances: value rtol 1e-5; gradient rtol 1e-5 with atol 1e-5 * max|g|
(float32 sums taken in a different order). The CUDA kernels themselves
run only on a GPU: ``test_torch_kernels_cuda.py`` holds them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_logpdf import ops as jops
from repro_torch.kernels import _build
from repro_torch.kernels.fused_logpdf import ops, ref

SIZES = [[1], [255, 257], [1000, 129, 1]]


def _segments(family, sizes, seed=0):
    rng = np.random.default_rng(seed)
    segs = []
    for n in sizes:
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


@pytest.mark.parametrize("family", ["std_normal", "bernoulli_logits"])
@pytest.mark.parametrize("sizes", SIZES, ids=lambda s: "x".join(map(str, s)))
def test_site_block_sum_matches_jax_pallas_and_ref(family, sizes):
    segs = _segments(family, sizes)
    jsegs = [tuple(jnp.asarray(a) for a in s) for s in segs]

    def jfun(ss):
        return jops.site_block_sum(family, ss, use_pallas=True, interpret=True)

    jval, jgrads = jax.value_and_grad(jfun)(jsegs)
    tsegs = [tuple(torch.tensor(a, requires_grad=True) for a in s)
             for s in segs]
    val = ops.site_block_sum(family, tsegs)
    val.backward()
    val = val.detach()
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-5)
    for tseg, jseg in zip(tsegs, jgrads):
        for t, j in zip(tseg, jseg):
            _assert_grad_close(t.grad.numpy(), j)
    # the plain version over the concatenated block agrees too
    cols = [np.concatenate(c) for c in zip(*segs)]
    if family == "std_normal":
        want = ref.std_normal_logpdf_sum_ref(torch.tensor(cols[0]))
    else:
        want = ref.bernoulli_logits_logpmf_sum_ref(*map(torch.tensor, cols))
    np.testing.assert_allclose(float(val), float(want), rtol=1e-5)


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
    assert ops.LAUNCHES == {"std_normal_sum": 0, "bernoulli_logit_sum": 0}


def test_row_wrappers_reject_what_the_kernel_cannot_take():
    with pytest.raises(TypeError):
        ops.std_normal_sum_rows(torch.zeros(2, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="inner stride"):
        ops.std_normal_sum_rows(torch.zeros(8, 2).t())
    with pytest.raises(ValueError, match="device"):
        ops.std_normal_sum_rows(torch.zeros(2, 8, device="meta"))
    with pytest.raises(ValueError, match="shape"):
        ops.bernoulli_logit_sum_rows(torch.zeros(2, 8), torch.zeros(2, 7))


def test_site_block_sum_families():
    assert float(ops.site_block_sum("std_normal", [])) == 0.0
    with pytest.raises(ValueError):
        ops.site_block_sum("poisson", [(torch.zeros(3),)])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.site_block_sum("categorical_logits",
                           [(torch.zeros(3, 2), torch.zeros(3))])


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
