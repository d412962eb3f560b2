"""PyTorch port: the hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test here needs a CUDA device: it carries the
``cuda`` marker and skips without one. The file imports only torch and the
port, so it runs on a GPU machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerance: rtol 1e-6 against the plain version (float32 sums in another
order); reruns must be bit-identical (no float atomics).
"""
import pytest
import torch

from repro_torch.kernels.fused_logpdf import ops, ref


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", [(1, 1), (4, 101), (4, 10000), (16, 257),
                                    (1, 1_000_003)])
def test_cuda_kernels_match_plain_versions(cuda_device, rows, n):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    z = torch.randn(rows, n, generator=gen, device=cuda_device)
    got = ops.std_normal_sum_rows(z)
    torch.testing.assert_close(got, ref.std_normal_logpdf_sum_ref(z),
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(ops.std_normal_sum_rows(z), got, rtol=0, atol=0)
    y = (torch.rand(n, generator=gen, device=cuda_device) < 0.5).float()
    ys = y.expand(rows, n)
    got = ops.bernoulli_logit_sum_rows(z, ys)
    torch.testing.assert_close(
        got, ref.bernoulli_logits_logpmf_sum_ref(z, ys), rtol=1e-6, atol=0)
    torch.testing.assert_close(ops.bernoulli_logit_sum_rows(z, ys), got,
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_vmap_grad_is_one_launch_for_all_chains(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    z = torch.randn(4, 10000, generator=gen, device=cuda_device)
    y = (torch.rand(10000, generator=gen, device=cuda_device) < 0.5).float()
    ops.reset_launch_counts()
    g = torch.func.vmap(torch.func.grad(ops.std_normal_logpdf_sum))(z)
    gl = torch.func.vmap(torch.func.grad(ops.bernoulli_logits_logpmf_sum),
                         in_dims=(0, None))(z, y)
    assert ops.LAUNCHES == {"std_normal_sum": 1, "bernoulli_logit_sum": 1}
    torch.testing.assert_close(g, -z, rtol=1e-6, atol=0)
    torch.testing.assert_close(gl, y - torch.sigmoid(z), rtol=1e-6, atol=1e-7)
