"""PyTorch port: the hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test here needs a CUDA device: it carries the
``cuda`` marker and skips without one. The file imports only torch and the
port, so it runs on a GPU machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: the fused_logpdf sums at rtol 1e-6 against the plain version
(float32 sums in another order); gamma_unnorm_sum, beta_unnorm_sum and
normal_sum, whose terms change sign, at 1e-6 of the sum of the terms'
magnitudes; mvn_quadform_sum (a float32 product over D terms per entry,
with a positive definite precision) at rtol 1e-5. The fused leapfrog's q, p and gradient at
rtol 1e-5 plus atol 1e-5 * max|plain| (nvcc contracts the updates into
FMAs, torch does not; the difference compounds over the steps), its
potential at 1e-5 * sum|v_i| (a float32 sum of up to 10^6 terms in
another order). The flash-attention and SSD-scan kernels by
``tests/test_kernels.py``'s measure, max|kernel - plain| / max|plain|:
flash 2e-5 in float32 and 3e-2 in bf16, ssd_scan 2e-4 and 5e-2 (float32
math in another order; bf16 outputs round, and ssd_scan_tc rounds W, S and
B o segdt to bf16 for the tensor cores; flash_fwd_tf32 and ssd_scan_tf32
hold the float32 tolerances with 3xTF32 products, whose dropped lo*lo term
is about 2^-22 of each). Reruns must be bit-identical (no float atomics).
The samplers' paths: a NUTS draw launches ``fused_potential_vg`` once a
lockstep leaf iteration, exactly; ``grad`` of a ``vmap`` (ADVI's order)
through the std_normal, bernoulli and gamma wrappers at rtol 1e-5 of the
plain version's.
"""
import time

import pytest
import torch

from repro_torch.kernels.fused_leapfrog import ops as lf_ops
from repro_torch.kernels.fused_leapfrog import ref as lf_ref
from repro_torch.kernels.fused_leapfrog.spec import (OP_NORMAL,
                                                     potential_elem_value)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.fused_logpdf import ops, ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref


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
    assert ops.LAUNCHES == {**dict.fromkeys(ops.LAUNCHES, 0),
                            "std_normal_sum": 1, "bernoulli_logit_sum": 1}
    torch.testing.assert_close(g, -z, rtol=1e-6, atol=0)
    torch.testing.assert_close(gl, y - torch.sigmoid(z), rtol=1e-6, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 2, 5, 20, 31, 32, 33, 100, 4096])
@pytest.mark.parametrize("rows,n", [(1, 1), (4, 99), (16, 257), (4, 10176)])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_row"])
def test_cuda_categorical_matches_plain_version(cuda_device, c, rows, n,
                                                shared):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    logits = 3.0 * torch.randn(rows, n, c, generator=gen, device=cuda_device)
    labels = torch.randint(0, c, (n,) if shared else (rows, n), generator=gen,
                           device=cuda_device, dtype=torch.int32)
    labels = labels.expand(rows, n)
    got = ops.categorical_logits_sum_rows(logits, labels)
    torch.testing.assert_close(
        got, ref.categorical_logits_logpmf_sum_ref(logits, labels),
        rtol=1e-6, atol=0)
    assert torch.equal(ops.categorical_logits_sum_rows(logits, labels), got)


@pytest.mark.cuda
def test_cuda_categorical_edges_match_plain_version(cuda_device):
    """Labels outside [0, C), -inf logits and a row of -inf: NaN and -inf
    where the plain version gives them."""
    ninf = float("-inf")
    logits = torch.randn(2, 6, 40, device=cuda_device)
    logits[:, 1, ::3] = ninf
    logits[:, 2, :] = ninf
    logits[:, 3, 7] = ninf
    labels = torch.tensor([[0, 2, 5, 7, 1, 2], [0, 1, 5, 6, -1, 40]],
                          dtype=torch.int32, device=cuda_device)
    got = ops.categorical_logits_sum_rows(logits, labels)
    want = ref.categorical_logits_logpmf_sum_ref(logits, labels)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0, equal_nan=True)
    keep = torch.tensor([0, 1, 3, 4, 5], device=cuda_device)
    lab = torch.tensor([[0, 1, 3, 4, 5], [0, 3, 7, 2, 2]], dtype=torch.int32,
                       device=cuda_device)
    sub = logits[:, keep].contiguous()
    torch.testing.assert_close(ops.categorical_logits_sum_rows(sub, lab),
                               ref.categorical_logits_logpmf_sum_ref(sub, lab),
                               rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", [(1, 1), (4, 1), (4, 101), (16, 257),
                                    (4, 40000), (1, 1_000_003)])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_row"])
def test_cuda_gamma_matches_plain_version(cuda_device, rows, n, shared):
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x = 0.05 + 4.0 * torch.rand(rows, n, generator=gen, device=cuda_device)
    pshape = (n,) if shared else (rows, n)
    am1 = -0.5 + 3.5 * torch.rand(pshape, generator=gen, device=cuda_device)
    rate = 0.2 + 3.0 * torch.rand(pshape, generator=gen, device=cuda_device)
    am1, rate = am1.expand(rows, n), rate.expand(rows, n)
    got = ops.gamma_unnorm_sum_rows(x, am1, rate)
    want = ref.gamma_unnorm_logpdf_sum_ref(x, am1, rate)
    abs_sum = (am1 * torch.log(x)).abs().sum(-1) + (rate * x).abs().sum(-1)
    assert bool(((got - want).abs() <= 1e-6 * abs_sum).all())
    assert torch.equal(ops.gamma_unnorm_sum_rows(x, am1, rate), got)


# std_normal_sum, gamma_unnorm_sum, beta_unnorm_sum, student_t_unnorm_sum
# and normal_sum, one launch a call: one block a row up to ops.REDUCE_SHARE floats, the
# last block of a row merging beyond
ONE_LAUNCH_SHAPES = [(1, 1), (4, 11), (4, 101), (4, 400),
                     (4, ops.REDUCE_SHARE - 1),
                     (4, ops.REDUCE_SHARE), (4, ops.REDUCE_SHARE + 1),
                     (4, 40000), (16, 257), (1, 1_000_003)]
ONE_LAUNCH = ("std_normal_sum", "gamma_unnorm_sum", "beta_unnorm_sum",
              "student_t_unnorm_sum", "normal_sum", "bernoulli_logit_sum")
# the four whose inputs also take an element stride of 0 (one value a row)
ELEM_STRIDED = ("beta_unnorm_sum", "student_t_unnorm_sum", "normal_sum",
                "bernoulli_logit_sum")
# beta's and student_t's main paths: mixed's 4 x 1 and 4 x 8,
# family_mix_8k's 4 x 1,024 and 4 x 2,048, and the wide timing shape
ELEM_MAIN_SHAPES = [(4, 1), (4, 8), (4, 1024), (4, 2048), (4, 40000)]


def _rows(rows, n, gen, dev, layout, lo=0.0, scale=1.0, randn=False,
          coin=False):
    """``(rows, n)`` float32: "aligned" a fresh tensor, "offset" a view one
    float past a 16-byte boundary (z[:, 1:] of one row), "shared" one row
    at row stride 0, "scalar" one value a row (element stride 0); with
    ``coin`` each value is 0 or 1 (bernoulli's y)."""
    def draw(*shape):
        v = lo + scale * (torch.randn if randn else torch.rand)(
            *shape, generator=gen, device=dev)
        return (v < 0.5).float() if coin else v

    if layout == "offset":
        return draw(rows * n + 1)[1:].view(rows, n)
    if layout == "shared":
        return draw(n).expand(rows, n)
    if layout == "scalar":
        return draw(rows, 1).expand(rows, n)
    return draw(rows, n)


def _one_launch_case(family, rows, n, layout, gen, dev):
    """(wrapper, inputs, plain version, the sum's scale for the gate): the
    value dense (or offset), the parameters in ``layout``."""
    value = "offset" if layout == "offset" else "aligned"
    if family == "std_normal_sum":
        z = _rows(rows, n, gen, dev, value, scale=2.0, randn=True)
        want = ref.std_normal_logpdf_sum_ref(z)
        return ops.std_normal_sum_rows, (z,), want, want.abs()
    if family == "student_t_unnorm_sum":
        z = _rows(rows, n, gen, dev, value, scale=3.0, randn=True)
        df = _rows(rows, n, gen, dev, layout, lo=0.5, scale=29.5)
        want = ref.student_t_unnorm_logpdf_sum_ref(z, df)
        return ops.student_t_unnorm_sum_rows, (z, df), want, want.abs()
    if family == "normal_sum":
        x = _rows(rows, n, gen, dev, value, scale=2.0, randn=True)
        mu = _rows(rows, n, gen, dev, layout, lo=-1.0, scale=2.0)
        sig = _rows(rows, n, gen, dev, layout, lo=0.3, scale=2.7)
        return (ops.normal_sum_rows, (x, mu, sig),
                ref.normal_logpdf_sum_ref(x, mu, sig),
                _abs_terms("normal", (x, mu, sig)))
    if family == "bernoulli_logit_sum":  # every term <= 0
        logits = _rows(rows, n, gen, dev, value, scale=2.0, randn=True)
        y = _rows(rows, n, gen, dev, layout, coin=True)
        want = ref.bernoulli_logits_logpmf_sum_ref(logits, y)
        return ops.bernoulli_logit_sum_rows, (logits, y), want, want.abs()
    if family == "beta_unnorm_sum":
        x = _rows(rows, n, gen, dev, value, lo=0.01, scale=0.98)
        am1 = _rows(rows, n, gen, dev, layout, lo=-0.5, scale=3.5)
        bm1 = _rows(rows, n, gen, dev, layout, lo=-0.5, scale=3.5)
        want = ref.beta_unnorm_logpdf_sum_ref(x, am1, bm1)
        terms = ((am1 * torch.log(x)).abs()
                 + (bm1 * torch.log1p(-x)).abs()).sum(-1)
        return ops.beta_unnorm_sum_rows, (x, am1, bm1), want, terms
    x = _rows(rows, n, gen, dev, value, lo=0.05, scale=4.0)
    am1 = _rows(rows, n, gen, dev, layout, lo=-0.5, scale=3.5)
    rate = _rows(rows, n, gen, dev, layout, lo=0.2, scale=3.0)
    want = ref.gamma_unnorm_logpdf_sum_ref(x, am1, rate)
    terms = (am1 * torch.log(x)).abs().sum(-1) + (rate * x).abs().sum(-1)
    return ops.gamma_unnorm_sum_rows, (x, am1, rate), want, terms


def _plan_of(args, rows, n, family="std_normal_sum"):
    """The plan the wrapper takes: beta and student_t read each input's
    element stride as well."""
    if family in ELEM_STRIDED:
        return ops.reduce_plan(n, ops._reduce_inputs(args, rows, n, True))
    return ops.reduce_plan(n, [(t.data_ptr(), t.stride(0) if rows > 1 else 0)
                               for t in args])


def _counts_are_zero(stream):
    """The stream's last-block counts (the one-launch reductions' and the
    fused leapfrog's), read back: all 0 (or never made)."""
    from repro_torch.kernels._scratch import SCRATCH
    torch.cuda.synchronize()
    entry = SCRATCH.get((torch.cuda.current_device(), stream.cuda_stream))
    return entry is None or not bool(entry[1].any())


@pytest.mark.cuda
@pytest.mark.parametrize("family,layout", [
    ("std_normal_sum", "aligned"), ("std_normal_sum", "offset"),
    ("gamma_unnorm_sum", "aligned"), ("gamma_unnorm_sum", "offset"),
    ("gamma_unnorm_sum", "shared")] + [
    (family, layout) for family in ELEM_STRIDED
    for layout in ("aligned", "offset", "shared", "scalar")])
@pytest.mark.parametrize("rows,n", ONE_LAUNCH_SHAPES)
def test_cuda_one_launch_sums_match_plain_versions(cuda_device, family,
                                                   layout, rows, n):
    """Both paths (one block a row, last-block merge) and both load widths,
    at rtol 1e-6 (std_normal, student_t: every term <= 0) and 1e-6 of
    sum|terms| (gamma, beta), one launch a call, bit-identical on a rerun,
    counts back at 0. "shared" gives the parameters at row stride 0,
    "scalar" one value a row (element stride 0: it never bars 16-byte
    loads, and a row of one element is one value a row)."""
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    kern, args, want, scale = _one_launch_case(family, rows, n, layout, gen,
                                               cuda_device)
    plan = _plan_of(args, rows, n, family)
    assert plan.nparts == -(-n // ops.REDUCE_SHARE)
    assert plan.vec == ((family in ELEM_STRIDED and n == 1)
                        or (layout != "offset" and (rows == 1 or n % 4 == 0)))
    ops.reset_launch_counts()
    got = kern(*args)
    assert ops.LAUNCHES[family] == 1
    assert bool(((got - want).abs() <= 1e-6 * scale).all())
    assert torch.equal(kern(*args), got)
    assert _counts_are_zero(torch.cuda.current_stream())


@pytest.mark.cuda
@pytest.mark.parametrize("family", ONE_LAUNCH)
@pytest.mark.parametrize("rows,n", [(4, 40000), (1, 1_000_003)])
def test_cuda_one_launch_reruns_and_two_streams(cuda_device, family, rows, n):
    """The last-block merge: 100 back-to-back calls bit-identical, calls
    alternating between two streams equal to them, every count back at 0
    on each stream."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    kern, args, _, _ = _one_launch_case(family, rows, n, "shared", gen,
                                        cuda_device)
    _assert_reruns_and_two_streams(cuda_device, kern, args)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ELEM_STRIDED)
@pytest.mark.parametrize("layout", ["aligned", "offset", "scalar"])
@pytest.mark.parametrize("rows,n", [(4, ops.REDUCE_SHARE),
                                    (4, ops.REDUCE_SHARE + 1), (4, 40000),
                                    (1, 1_000_003)])
def test_cuda_elem_strided_reruns_and_two_streams(cuda_device, family,
                                                  layout, rows, n):
    """Beta, student_t and normal in the layouts the shared-row test above
    leaves out: dense parameters, offset views (4-byte loads) and one value
    a row (element stride 0), either side of one block's share and
    merging."""
    gen = torch.Generator(device=cuda_device).manual_seed(15)
    kern, args, _, _ = _one_launch_case(family, rows, n, layout, gen,
                                        cuda_device)
    plan = _plan_of(args, rows, n, family)
    assert plan.vec == (layout != "offset" and (rows == 1 or n % 4 == 0))
    _assert_reruns_and_two_streams(cuda_device, kern, args)


def _assert_reruns_and_two_streams(cuda_device, kern, args):
    first = kern(*args)
    again = [kern(*args) for _ in range(100)]
    assert all(torch.equal(a, first) for a in again)
    assert _counts_are_zero(torch.cuda.current_stream())
    streams = (torch.cuda.Stream(cuda_device), torch.cuda.Stream(cuda_device))
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = []
    for i in range(20):
        with torch.cuda.stream(streams[i % 2]):
            got.append(kern(*args))
    for s in streams:
        torch.cuda.current_stream().wait_stream(s)
        assert _counts_are_zero(s)
    assert all(torch.equal(g, first) for g in got)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ONE_LAUNCH)
@pytest.mark.parametrize("rows,n", [(1, 1), (4, 11), (4, 400), (4, 10000),
                                    (4, 40000), (1, 1_000_003)])
def test_cuda_one_launch_is_one_kernel_by_profiler(cuda_device, family, rows,
                                                   n):
    """One kernel a call (row_sum), and no finish_rows, at the main
    paths' shapes (logreg's bernoulli at 4 x 10,000), one element and a
    row of many blocks, counted by the nodes of a CUDA graph of 10 calls
    (``_graph_kernels``)."""
    gen = torch.Generator(device=cuda_device).manual_seed(14)
    kern, args, _, _ = _one_launch_case(family, rows, n, "shared", gen,
                                        cuda_device)
    _assert_one_kernel_a_call(kern, args)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ELEM_STRIDED)
@pytest.mark.parametrize("layout", ["shared", "scalar", "offset"])
@pytest.mark.parametrize("rows,n", ELEM_MAIN_SHAPES)
def test_cuda_elem_strided_one_kernel_by_profiler(cuda_device, family,
                                                  layout, rows, n):
    """Beta, student_t and normal at the main paths' shapes, in the
    layouts the paths pass (a shared parameter row), one value a row and
    offset views: one row_sum kernel a call."""
    gen = torch.Generator(device=cuda_device).manual_seed(16)
    kern, args, _, _ = _one_launch_case(family, rows, n, layout, gen,
                                        cuda_device)
    _assert_one_kernel_a_call(kern, args)


WINDOW_PAD_S = 0.02  # host seconds between a window's edges and its calls


def _kernel_windows(fn, calls=10, per_call=1, only=None):
    """The names of the CUDA kernels that ``calls`` calls of ``fn`` launch,
    by torch.profiler, one list a window. Each window starts with one
    marker launch (``torch.cuda._sleep``'s spin_kernel) that is left out:
    the profiler can drop a window's first kernel (seen on the H100). The
    calls are issued WINDOW_PAD_S after the window opens and it closes
    WINDOW_PAD_S after they end: the profiler keeps only device activity
    whose time, carried into the host's clock, falls inside the window,
    and late in a long process that carried time can sit off the host's.
    A window short of ``per_call * calls`` kernels is taken again, up to
    three windows; the last is the complete one, if any was. ``only``
    keeps the kernels whose names contain it (a path that also launches
    PyTorch's own kernels). Left to the one path a graph cannot hold, a
    NUTS draw (its loop tests read the device): the one-kernel-a-call
    tests count by ``_graph_kernels``."""
    from torch.profiler import ProfilerActivity, profile
    fn()  # scratch and library in place before the window
    torch.cuda.synchronize()
    windows = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(WINDOW_PAD_S)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(WINDOW_PAD_S)
        windows.append([e.key for e in prof.key_averages()
                        if e.device_type.name == "CUDA"
                        and "spin_kernel" not in e.key
                        and (only is None or only in e.key)
                        for _ in range(e.count)])
        if len(windows[-1]) == per_call * calls:
            break
    return windows


def _demangle(name: bytes) -> str:
    """A kernel's C++ name as the profiler shows it (``__cxa_demangle``)."""
    import ctypes
    fn = getattr(ctypes.CDLL("libstdc++.so.6"), "__cxa_demangle")
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_void_p
    free = ctypes.CDLL("libc.so.6").free
    free.argtypes, free.restype = [ctypes.c_void_p], None
    status = ctypes.c_int(0)
    out = fn(name, None, None, ctypes.byref(status))
    if status.value != 0 or not out:
        return name.decode()
    text = ctypes.string_at(out).decode()
    free(out)
    return text


def _graph_kernels(fn, calls=10):
    """The device work that ``calls`` calls of ``fn`` launch, as the nodes
    of one CUDA graph recorded from them (``core.program._recording``: the
    capture stream's kernel scratch sized first), read through the CUDA
    API (``cuGraph*``):
    each kernel node's demangled name, any other node as ``<node type
    N>``. The clock for the one-kernel-a-call tests: a graph holds every
    launch the calls make, where a torch.profiler window in a process that
    built its kernels lost one of ten on the leapfrog, flash and SSD
    kernels (``probes/profiler_windows_cold.py``). Nothing is replayed."""
    import ctypes

    from repro_torch.core.program import _recording

    cuda = ctypes.CDLL("libcuda.so.1")
    vp = ctypes.c_void_p
    cuda.cuGraphGetNodes.argtypes = [vp, vp, ctypes.POINTER(ctypes.c_size_t)]
    cuda.cuGraphNodeGetType.argtypes = [vp, ctypes.POINTER(ctypes.c_int)]
    cuda.cuFuncGetName.argtypes = [ctypes.POINTER(ctypes.c_char_p), vp]
    cuda.cuKernelGetName.argtypes = [ctypes.POINTER(ctypes.c_char_p), vp]
    for f in (cuda.cuGraphGetNodes, cuda.cuGraphNodeGetType,
              cuda.cuFuncGetName, cuda.cuKernelGetName):
        f.restype = ctypes.c_int  # CUresult
    fn()  # scratch and library in place before the capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with _recording(g, torch.device("cuda", torch.cuda.current_device())):
        for _ in range(calls):
            fn()
    graph = g.raw_cuda_graph()
    n = ctypes.c_size_t(0)
    assert cuda.cuGraphGetNodes(graph, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cuda.cuGraphGetNodes(graph, ctypes.cast(nodes, vp),
                                ctypes.byref(n)) == 0

    class Params(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = ([("func", ctypes.c_void_p)]
                    + [(f, ctypes.c_uint) for f in ("gx", "gy", "gz", "bx",
                                                    "by", "bz", "shmem")]
                    + [(f, ctypes.c_void_p) for f in ("params", "extra",
                                                      "kern", "ctx")])

    get_params = getattr(cuda, "cuGraphKernelNodeGetParams_v2",
                         cuda.cuGraphKernelNodeGetParams)
    get_params.argtypes = [vp, ctypes.POINTER(Params)]
    get_params.restype = ctypes.c_int
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cuda.cuGraphNodeGetType(node, ctypes.byref(kind)) == 0
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            names.append(f"<node type {kind.value}>")
            continue
        p = Params()
        assert get_params(node, ctypes.byref(p)) == 0
        name = ctypes.c_char_p()
        err = (cuda.cuFuncGetName(ctypes.byref(name), p.func) if p.func
               else cuda.cuKernelGetName(ctypes.byref(name), p.kern))
        assert err == 0 and name.value, f"no name for a kernel node ({err})"
        names.append(_demangle(name.value))
    return names


def _assert_one_kernel_a_call(kern, args, kernel="row_sum"):
    """10 calls launch 10 kernels named ``kernel`` and nothing else, by the
    nodes of a CUDA graph of the calls (``_graph_kernels``)."""
    names = _graph_kernels(lambda: kern(*args))
    assert all(kernel in k for k in names), names
    assert len(names) == 10, names


@pytest.mark.cuda
def test_cuda_one_launch_refuses_bad_plans(cuda_device):
    """The C interface refuses 16-byte loads on an unaligned row, parts
    that are not ceil(n / REDUCE_SHARE), and a merge without scratch: each
    returns a CUDA error, which the wrapper's check raises as KernelError."""
    from repro_torch.kernels._build import KernelError
    share = ops.REDUCE_SHARE
    z = torch.zeros(4 * (share + 1) + 1, device=cuda_device)
    view = z[1:].view(4, share + 1)
    fn = ops._lib().repro_std_normal_sum
    stream = torch.cuda.current_stream().cuda_stream
    assert torch._C._cuda_getCurrentRawStream(torch.cuda.current_device()) \
        == stream  # the raw handle the wrapper passes
    out = torch.empty(4, device=cuda_device)
    assert fn(view.data_ptr(), share + 1, 4, share + 1, 2, 1, None, None,
              out.data_ptr(), stream) != 0
    assert fn(z.data_ptr(), share, 4, share, 2, 1, None, None,
              out.data_ptr(), stream) != 0
    err = fn(z.data_ptr(), 0, 1, share + 1, 2, 0, None, None, out.data_ptr(),
             stream)
    with pytest.raises(KernelError, match="std_normal_sum"):
        ops._raise_on(err, "std_normal_sum")


@pytest.mark.cuda
def test_cuda_elem_strided_refuses_bad_plans(cuda_device):
    """beta's and student_t's C side refuses an element stride outside
    {0, 1}, 16-byte loads on an unaligned dense input (an unaligned input
    of element stride 0 is taken), parts that are not ceil(n /
    REDUCE_SHARE) and a merge without scratch; the wrapper raises the
    error as KernelError."""
    from repro_torch.kernels._build import KernelError
    share = ops.REDUCE_SHARE
    z = torch.full((4 * (share + 1) + 1,), 0.5, device=cuda_device)
    view = z[1:].view(4, share + 1)
    beta = ops._lib().repro_beta_unnorm_sum
    st = ops._lib().repro_student_t_unnorm_sum
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty(4, device=cuda_device)
    a, v = z.data_ptr(), view.data_ptr()
    tail = (4, share, 1, 1, None, None, out.data_ptr(), stream)
    # element stride 2
    assert beta(a, share, 1, a, share, 2, a, share, 1, *tail) != 0
    assert st(a, share, 2, a, share, 1, *tail) != 0
    # 16-byte loads: an unaligned dense input refused, one value a row taken
    assert beta(v, share + 1, 1, a, 0, 1, a, 0, 1, *tail) != 0
    assert st(a, share, 1, v, share + 1, 1, *tail) != 0
    assert st(a, share, 1, v, 1, 0, *tail) == 0
    assert beta(a, share, 1, v, 1, 0, v, 0, 0, *tail) == 0
    normal = ops._lib().repro_normal_sum
    assert normal(a, share, 1, a, share, 3, a, share, 1, *tail) != 0
    assert normal(v, share + 1, 1, a, 0, 1, a, 0, 1, *tail) != 0
    assert normal(a, 0, 1, v, 1, 0, v, 1, 0, *tail) == 0  # the switch route
    bern = ops._lib().repro_bernoulli_logit_sum
    assert bern(a, share, 2, a, 0, 1, *tail) != 0
    assert bern(v, share + 1, 1, a, 0, 1, *tail) != 0
    assert bern(a, share, 1, v, 0, 1, *tail) != 0
    assert bern(a, share, 1, v, 1, 0, *tail) == 0  # one y a row
    torch.cuda.synchronize()
    # parts not ceil(n / share), and a merge without scratch
    assert st(a, share, 1, a, share, 1, 4, share, 2, 1, None, None,
              out.data_ptr(), stream) != 0
    err = beta(a, 0, 1, a, 0, 1, a, 0, 1, 1, share + 1, 2, 0, None, None,
               out.data_ptr(), stream)
    assert err != 0
    with pytest.raises(KernelError, match="beta_unnorm_sum"):
        ops._raise_on(err, "beta_unnorm_sum")


# normal_sum as gauss_unknown's switch route passes it (shared x, one mu
# and one sigma a chain), one value a row, shared rows and offset views
NORMAL_LAYOUTS = ("switch", "scalar", "shared", "offset")
MAIN_DIMS = (1, 255, 256, 257, 2047, 2049, 10000, 1_000_003)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", NORMAL_LAYOUTS)
@pytest.mark.parametrize("n", MAIN_DIMS)
def test_cuda_normal_sum_one_launch_layouts(cuda_device, layout, n):
    """One row_sum launch a call at 1e-6 of sum|terms|, bit-identical on a
    rerun, the counts back at 0; "switch" reads the data at row stride 0
    and the parameters at element stride 0, which never bars 16-byte
    loads; "offset" takes the 4-byte loads."""
    gen = torch.Generator(device=cuda_device).manual_seed(20)
    rows = 1 if n == 1_000_003 else 4
    if layout == "switch":
        x = _rows(rows, n, gen, cuda_device, "shared", scale=2.0, randn=True)
        mu = _rows(rows, n, gen, cuda_device, "scalar", lo=-1.0, scale=2.0)
        sig = _rows(rows, n, gen, cuda_device, "scalar", lo=0.3, scale=2.7)
        args = (x, mu, sig)
        want = ref.normal_logpdf_sum_ref(*args)
        scale = _abs_terms("normal", args)
    else:
        _, args, want, scale = _one_launch_case("normal_sum", rows, n, layout,
                                                gen, cuda_device)
    plan = _plan_of(args, rows, n, "normal_sum")
    assert plan.vec == (n == 1 or (layout != "offset" and (
        rows == 1 or n % 4 == 0 or layout == "switch")))
    ops.reset_launch_counts()
    got = ops.normal_sum_rows(*args)
    assert ops.LAUNCHES["normal_sum"] == 1
    assert bool(((got - want).abs() <= 1e-6 * scale).all())
    assert torch.equal(ops.normal_sum_rows(*args), got)
    assert _counts_are_zero(torch.cuda.current_stream())


@pytest.mark.cuda
def test_cuda_new_kernels_one_launch_for_all_chains(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    logits = torch.randn(4, 100, 20, generator=gen, device=cuda_device)
    labels = torch.randint(0, 20, (100,), generator=gen, device=cuda_device,
                           dtype=torch.int32)
    x = 0.1 + torch.rand(4, 11, generator=gen, device=cuda_device)
    ops.reset_launch_counts()
    gl = torch.func.vmap(torch.func.grad(ops.categorical_logits_logpmf_sum),
                         in_dims=(0, None))(logits, labels)
    gx = torch.func.vmap(torch.func.grad(ops.gamma_unnorm_logpdf_sum),
                         in_dims=(0, None, None))(
        x, torch.zeros(11, device=cuda_device),
        torch.ones(11, device=cuda_device))
    assert ops.LAUNCHES == {**dict.fromkeys(ops.LAUNCHES, 0),
                            "categorical_logits_sum_small": 1,
                            "gamma_unnorm_sum": 1}
    onehot = torch.nn.functional.one_hot(labels.long(), 20).float()
    torch.testing.assert_close(gl, onehot - torch.softmax(logits, -1),
                               rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(gx, -torch.ones_like(x), rtol=0, atol=0)


def _elementwise_case(family, rows, n, params, gen, dev):
    """Inputs of one per-element kernel: ``params`` is "per_row" (dense),
    "shared" (row stride 0) or "scalar" (one value per row: element
    stride 0, gauss_unknown's mu and sigma)."""
    def param(lo, hi):
        shape = {"per_row": (rows, n), "shared": (n,),
                 "scalar": (rows, 1)}[params]
        return (lo + (hi - lo) * torch.rand(shape, generator=gen,
                                            device=dev)).expand(rows, n)

    if family == "normal":
        x = 2.0 * torch.randn(rows, n, generator=gen, device=dev)
        args = (x, param(-1.0, 1.0), param(0.3, 3.0))
        terms = ref.normal_logpdf_sum_ref
        return ops.normal_sum_rows, args, terms
    if family == "beta":
        x = 0.01 + 0.98 * torch.rand(rows, n, generator=gen, device=dev)
        return (ops.beta_unnorm_sum_rows,
                (x, param(-0.5, 3.0), param(-0.5, 3.0)),
                ref.beta_unnorm_logpdf_sum_ref)
    z = 3.0 * torch.randn(rows, n, generator=gen, device=dev)
    return (ops.student_t_unnorm_sum_rows, (z, param(0.5, 30.0)),
            ref.student_t_unnorm_logpdf_sum_ref)


def _abs_terms(family, args):
    """sum_i of each term's magnitude, the scale a sign-changing sum is
    held at."""
    if family == "normal":
        x, loc, scale = args
        z = (x - loc) / scale
        return (0.5 * z * z).sum(-1) + torch.log(scale).abs().sum(-1) \
            + 0.9189385 * x.shape[-1]
    x, am1, bm1 = args
    return ((am1 * torch.log(x)).abs() + (bm1 * torch.log1p(-x)).abs()).sum(-1)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["normal", "beta", "student_t"])
@pytest.mark.parametrize("rows,n", [(1, 1), (4, 1), (4, 1024), (4, 2048),
                                    (4, 10000), (16, 257), (1, 1_000_003)])
@pytest.mark.parametrize("params", ["per_row", "shared", "scalar"])
def test_cuda_elementwise_families_match_plain_versions(cuda_device, family,
                                                        rows, n, params):
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    kern, args, plain = _elementwise_case(family, rows, n, params, gen,
                                          cuda_device)
    got = kern(*args)
    want = plain(*args)
    if family == "student_t":  # every term <= 0: no cancellation
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    else:
        assert bool(((got - want).abs()
                     <= 1e-6 * _abs_terms(family, args)).all())
    assert torch.equal(kern(*args), got)


def _precision(d, gen, dev, rows=None):
    shape = (d, d) if rows is None else (rows, d, d)
    a = torch.randn(shape, generator=gen, device=dev) / d ** 0.5
    return a @ a.mT + torch.eye(d, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 5, 24, 63, 64, 65, 256, 1024])
@pytest.mark.parametrize("rows,n", [(1, 1), (4, 1), (4, 96), (4, 4096),
                                    (16, 257), (1, 100_000)])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_row"])
def test_cuda_mvn_quadform_matches_plain_version(cuda_device, d, rows, n,
                                                 shared):
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    xc = torch.randn(rows, n, d, generator=gen, device=cuda_device)
    prec = (_precision(d, gen, cuda_device).expand(rows, d, d) if shared
            else _precision(d, gen, cuda_device, rows))
    ops.reset_launch_counts()
    got = ops.mvn_quadform_sum_rows(xc, prec)
    torch.testing.assert_close(
        got, ref.mvnormal_prec_quadform_sum_ref(xc, prec), rtol=1e-5, atol=0)
    assert torch.equal(ops.mvn_quadform_sum_rows(xc, prec), got)
    assert ops.LAUNCHES["mvn_quadform_sum"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("d", [5, 63, 65, 256, 1024])
@pytest.mark.parametrize("n", [1, 100_000])
def test_cuda_mvn_quadform_stride0_rows_and_precision(cuda_device, d, n):
    """xc and P both at batch stride 0 (one data block and one precision
    shared by 4 chains): every row equals the one-row call, at rtol 1e-5
    against the plain version, bit-identical on a rerun."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    xc = torch.randn(1, n, d, generator=gen, device=cuda_device)
    prec = _precision(d, gen, cuda_device)[None]
    xs, ps = xc.expand(4, n, d), prec.expand(4, d, d)
    assert xs.stride(0) == 0 and ps.stride(0) == 0
    got = ops.mvn_quadform_sum_rows(xs, ps)
    torch.testing.assert_close(
        got, ref.mvnormal_prec_quadform_sum_ref(xs, ps), rtol=1e-5, atol=0)
    assert torch.equal(ops.mvn_quadform_sum_rows(xs, ps), got)
    assert torch.equal(got, ops.mvn_quadform_sum_rows(xc, prec).expand(4))


@pytest.mark.cuda
def test_cuda_slice_four_kernels_one_launch_for_all_chains(cuda_device):
    """Under vmap(grad) over 4 chains each of the four kernels launches once;
    gauss_unknown's normal route (shared x, one mu and sigma per chain) and
    a precision shared by the chains included."""
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    x = torch.randn(10000, generator=gen, device=cuda_device)
    mu = torch.randn(4, generator=gen, device=cuda_device)
    sig = 0.5 + torch.rand(4, generator=gen, device=cuda_device)
    xb = 0.05 + 0.9 * torch.rand(4, 1024, generator=gen, device=cuda_device)
    z = torch.randn(4, 2048, generator=gen, device=cuda_device)
    xc = torch.randn(4, 1, 5, generator=gen, device=cuda_device)
    prec = _precision(5, gen, cuda_device)
    ops.reset_launch_counts()
    gm, gs = torch.func.vmap(torch.func.grad(ops.normal_logpdf_sum,
                                             argnums=(1, 2)),
                             in_dims=(None, 0, 0))(x, mu, sig)
    gb = torch.func.vmap(torch.func.grad(ops.beta_unnorm_logpdf_sum),
                         in_dims=(0, None, None))(xb, 1.0, 2.0)
    gt = torch.func.vmap(torch.func.grad(ops.student_t_unnorm_logpdf_sum),
                         in_dims=(0, None))(z, 4.0)
    gq = torch.func.vmap(torch.func.grad(ops.mvnormal_prec_quadform_sum),
                         in_dims=(0, None))(xc, prec)
    assert ops.LAUNCHES == {**dict.fromkeys(ops.LAUNCHES, 0),
                            "normal_sum": 1, "beta_unnorm_sum": 1,
                            "student_t_unnorm_sum": 1, "mvn_quadform_sum": 1}
    zz = (x - mu[:, None]) / sig[:, None]
    torch.testing.assert_close(gm, (zz / sig[:, None]).sum(-1), rtol=1e-4,
                               atol=1e-2)
    torch.testing.assert_close(gs, ((zz * zz - 1) / sig[:, None]).sum(-1),
                               rtol=1e-4, atol=1e-2)
    torch.testing.assert_close(gb, 1.0 / xb - 2.0 / (1 - xb), rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(gt, -5.0 * z / (4.0 + z * z), rtol=1e-6,
                               atol=1e-7)
    torch.testing.assert_close(gq, -(xc @ prec), rtol=1e-5, atol=1e-6)


def _assert_state_close(got, want):
    atol = 1e-5 * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("uniform_op", [None, 0, 1, 2, 3, 4])
@pytest.mark.parametrize("rows,dim", [(1, 1), (4, 127), (16, 129),
                                      (4, 10000), (1, 1_000_003)])
@pytest.mark.parametrize("mass", [False, True])
def test_cuda_fused_leapfrog_matches_plain_version(cuda_device, uniform_op,
                                                   rows, dim, mass):
    spec = lf_ref.random_spec(dim, uniform_op)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    q = 0.5 * torch.randn(rows, dim, generator=gen, device=cuda_device)
    p = torch.randn(rows, dim, generator=gen, device=cuda_device)
    eps = 0.02 + 0.06 * torch.rand(rows, generator=gen, device=cuda_device)
    im = (0.5 + torch.rand(dim, generator=gen, device=cuda_device)
          if mass else None)
    _, g = lf_ops.potential_value_and_grad(spec, q)
    lp0, g0 = lf_ref.potential_value_and_grad_ref(spec, q)
    _assert_state_close(g, g0)
    for n_steps in (1, 4, 8):
        got = lf_ops.fused_leapfrog(spec, q, p, g, eps, n_steps, inv_mass=im)
        want = lf_ref.leapfrog_ref(spec, q, p, g, eps, n_steps, inv_mass=im)
        for a, b in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
            _assert_state_close(a, b)
        op, c0, c1, c2, c3 = spec.coeff_arrays(cuda_device)
        abs_sum = potential_elem_value(op, c0, c1, c2, c3, want[0],
                                       uniform_op=spec.uniform_op).abs().sum(-1)
        assert bool(((got[2] - want[2]).abs() <= 1e-5 * abs_sum + 1e-6).all())
        again = lf_ops.fused_leapfrog(spec, q, p, g, eps, n_steps,
                                      inv_mass=im)
        for a, b in zip(got, again):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_fused_leapfrog_counts_one_launch_per_call(cuda_device):
    spec = lf_ref.random_spec(10000, OP_NORMAL)
    q = torch.zeros(10000, device=cuda_device).expand(4, 10000)  # stride 0
    lf_ops.reset_launch_counts()
    lp, g = lf_ops.potential_value_and_grad(spec, q)
    lf_ops.fused_leapfrog(spec, q, q, g, 0.1, 4)
    assert lf_ops.LAUNCHES == {"fused_leapfrog": 1, "fused_potential_vg": 1}
    assert lp.shape == (4,)


# fused_leapfrog, one launch a call: one block a chain up to
# lf_ops.LEAPFROG_SHARE coordinates, the last block of a chain merging
# beyond (MAIN_DIMS: either side of one block, 2,047 and 2,049, the main
# paths' 10,000 and 8,192, and 1,000,003). "normal" is gaussian_10k's uniform table, "mixed" a table whose
# opcode changes every coordinate, "runs" family_mix_8k's layout (one
# opcode for each 512 coordinates).
LF_TABLES = {"normal": (OP_NORMAL, 1), "mixed": (None, 1), "runs": (None, 512)}


def _lf_case(table, rows, dim, gen, dev):
    uop, run = LF_TABLES[table]
    spec = lf_ref.random_spec(dim, uop, seed=dim, run=run)
    q = 0.5 * torch.randn(rows, dim, generator=gen, device=dev)
    p = torch.randn(rows, dim, generator=gen, device=dev)
    eps = 0.02 + 0.06 * torch.rand(rows, generator=gen, device=dev)
    _, g = lf_ref.potential_value_and_grad_ref(spec, q)
    return spec, q, p, g, eps


def _assert_leapfrog_close(spec, got, want):
    for a, b in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
        _assert_state_close(a, b)
    op, c0, c1, c2, c3 = spec.coeff_arrays(want[0].device)
    abs_sum = potential_elem_value(op, c0, c1, c2, c3, want[0],
                                   uniform_op=spec.uniform_op).abs().sum(-1)
    assert bool(((got[2] - want[2]).abs() <= 1e-5 * abs_sum + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("table", list(LF_TABLES))
@pytest.mark.parametrize("dim", MAIN_DIMS + (8192,))
@pytest.mark.parametrize("mass", [False, True])
def test_cuda_fused_leapfrog_one_launch_matches_plain_version(
        cuda_device, table, dim, mass):
    """At 0 and 4 steps: one launch a call, q, p, g and the potential at
    the plain version's tolerances (0 steps returns the inputs bit for
    bit), bit-identical on a rerun, the counts back at 0."""
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    rows = 1 if dim == 1_000_003 else 4
    spec, q, p, g, eps = _lf_case(table, rows, dim, gen, cuda_device)
    im = (0.5 + torch.rand(dim, generator=gen, device=cuda_device)
          if mass else None)
    for n_steps in (0, 4):
        lf_ops.reset_launch_counts()
        got = lf_ops.fused_leapfrog(spec, q, p, g, eps, n_steps, inv_mass=im)
        assert lf_ops.LAUNCHES == {"fused_leapfrog": 1,
                                   "fused_potential_vg": 0}
        want = lf_ref.leapfrog_ref(spec, q, p, g, eps, n_steps, inv_mass=im)
        _assert_leapfrog_close(spec, got, want)
        if n_steps == 0:
            for a, b in zip((got[0], got[1], got[3]), (q, p, g)):
                assert torch.equal(a, b)
        again = lf_ops.fused_leapfrog(spec, q, p, g, eps, n_steps,
                                      inv_mass=im)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        assert _counts_are_zero(torch.cuda.current_stream())


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["normal", "runs"])
@pytest.mark.parametrize("rows,dim", [(4, 1024), (4, 8192), (4, 10000),
                                      (1, 1_000_003)])
def test_cuda_fused_leapfrog_layouts_and_step_forms_give_the_same_bits(
        cuda_device, table, rows, dim):
    """The state as views one float past a 16-byte boundary, or q shared
    by the chains at row stride 0, gives the same bits as dense rows (a
    thread's coordinate and the sum's order come from dim alone); the step
    size given per chain, as one 0-d tensor or as a number, too."""
    gen = torch.Generator(device=cuda_device).manual_seed(22)
    spec, q, p, g, eps = _lf_case(table, rows, dim, gen, cuda_device)

    def offset(t):
        return torch.empty(t.numel() + 1, device=cuda_device)[1:] \
            .view_as(t).copy_(t)

    views = [offset(t) for t in (q, p, g)]
    outs = []
    for step in (eps, eps[0].clone(), float(eps[0])):
        got = lf_ops.fused_leapfrog(spec, q, p, g, step, 4)
        got4 = lf_ops.fused_leapfrog(spec, *views, step, 4)
        assert all(torch.equal(a, b) for a, b in zip(got, got4))
        outs.append(got)
    # one step for every chain as a 0-d tensor or a number; chain 0 takes
    # eps[0] in all three
    assert all(torch.equal(a, b) for a, b in zip(outs[1], outs[2]))
    assert all(torch.equal(a[0], b[0]) for a, b in zip(outs[0], outs[1]))
    if rows > 1:
        shared = q[:1].expand(rows, dim)
        assert shared.stride(0) == 0
        got = lf_ops.fused_leapfrog(spec, shared, p, g, eps, 4)
        want = lf_ops.fused_leapfrog(spec, shared.contiguous(), p, g, eps, 4)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["normal", "runs"])
@pytest.mark.parametrize("rows,dim", [(4, 10000), (1, 1_000_003)])
def test_cuda_fused_leapfrog_reruns_and_two_streams(cuda_device, table, rows,
                                                    dim):
    """The last-block merge: 100 back-to-back calls bit-identical, calls
    alternating between two streams equal to them, every count back at 0
    on each stream."""
    gen = torch.Generator(device=cuda_device).manual_seed(23)
    spec, q, p, g, eps = _lf_case(table, rows, dim, gen, cuda_device)

    def call():
        return lf_ops.fused_leapfrog(spec, q, p, g, eps, 4)

    first = call()
    assert all(all(torch.equal(a, b) for a, b in zip(call(), first))
               for _ in range(100))
    assert _counts_are_zero(torch.cuda.current_stream())
    streams = (torch.cuda.Stream(cuda_device), torch.cuda.Stream(cuda_device))
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = []
    for i in range(20):
        with torch.cuda.stream(streams[i % 2]):
            got.append(call())
    for s in streams:
        torch.cuda.current_stream().wait_stream(s)
        assert _counts_are_zero(s)
    assert all(all(torch.equal(a, b) for a, b in zip(out, first))
               for out in got)


@pytest.mark.cuda
@pytest.mark.parametrize("table,rows,dim", [("normal", 4, 512),
                                            ("normal", 4, 10000),
                                            ("runs", 4, 8192)])
def test_cuda_fused_leapfrog_is_one_kernel_by_profiler(cuda_device, table,
                                                       rows, dim):
    """One kernel a call (leapfrog_kernel), and no finish_rows, at
    gaussian_10k's and family_mix_8k's shapes and where a chain is one
    block, by the nodes of a CUDA graph of 10 calls."""
    gen = torch.Generator(device=cuda_device).manual_seed(24)
    spec, q, p, g, eps = _lf_case(table, rows, dim, gen, cuda_device)
    _assert_one_kernel_a_call(
        lambda *a: lf_ops.fused_leapfrog(spec, *a, 4), (q, p, g, eps),
        kernel="leapfrog_kernel")


@pytest.mark.cuda
def test_cuda_fused_leapfrog_refuses_bad_plans(cuda_device):
    """The C side refuses parts that are not ceil(dim / LEAPFROG_SHARE) and
    a merge without scratch; the wrapper raises its error as
    KernelError."""
    from repro_torch.kernels._build import KernelError
    share = lf_ops.LEAPFROG_SHARE
    dim = 2 * share
    spec = lf_ref.random_spec(dim, OP_NORMAL)
    table = [t.data_ptr() for t in spec.coeff_arrays(cuda_device)]
    z = torch.zeros(4 * dim, device=cuda_device)
    a = z.data_ptr()
    # every buffer the kernel writes stays alive through the test
    state = torch.empty(3 * 4 * dim, device=cuda_device)
    out = torch.empty(4, device=cuda_device)
    partials = torch.empty(4 * 2, device=cuda_device)
    counts = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    fn = lf_ops._lib().repro_fused_leapfrog
    stream = torch.cuda.current_stream().cuda_stream

    def call(n, nparts, scratch=True):
        return fn(a, n, a, n, a, n, None, 0, 0.1, *table, None, OP_NORMAL, 4,
                  n, 4, nparts, state.data_ptr(),
                  partials.data_ptr() if scratch else None,
                  counts.data_ptr() if scratch else None, -1.25,
                  out.data_ptr(), stream)

    assert call(dim, 2) == 0
    assert call(dim - 1, 2) == 0
    assert call(share, 1, scratch=False) == 0  # one block a chain
    torch.cuda.synchronize()
    assert not bool(counts.any())
    assert call(dim, 3) != 0                    # parts
    assert call(dim, 2, scratch=False) != 0     # a merge, no scratch
    err = call(dim, 1)
    with pytest.raises(KernelError, match="fused_leapfrog"):
        lf_ops._raise_on(err, "fused_leapfrog")


# fused_potential_vg, one launch a call: fused_leapfrog's kernel evaluating
# the gradient at u, with the same blocks a chain and the same last-block
# merge and scratch.
def _potential_state(table, rows, dim, layout, gen, dev):
    """(spec, u, p) with u dense (rows, dim), one chain as a 1-D u, or one
    row shared by the chains at row stride 0; p of u's shape."""
    uop, run = LF_TABLES[table]
    spec = lf_ref.random_spec(dim, uop, seed=dim, run=run)
    if layout == "1-D":
        u = 0.5 * torch.randn(dim, generator=gen, device=dev)
    elif layout == "row stride 0":
        u = (0.5 * torch.randn(dim, generator=gen, device=dev)).expand(rows,
                                                                       dim)
    else:
        u = 0.5 * torch.randn(rows, dim, generator=gen, device=dev)
    return spec, u, torch.randn(u.shape, generator=gen, device=dev)


def _assert_potential_one_launch(spec, u, p):
    """One launch and one kernel a call (by the counts and a CUDA graph's
    nodes),
    value and gradient at the plain version's tolerances, a rerun
    bit-identical, the counts back at 0, and calls alternating with
    fused_leapfrog's on one stream (sharing its scratch) giving the same
    bits."""
    lf_ops.reset_launch_counts()
    lp, g = lf_ops.potential_value_and_grad(spec, u)
    assert lf_ops.LAUNCHES == {"fused_leapfrog": 0, "fused_potential_vg": 1}
    assert lp.shape == u.shape[:-1] and g.shape == u.shape
    want_lp, want_g = lf_ref.potential_value_and_grad_ref(spec, u)
    _assert_state_close(g, want_g)
    abs_sum = potential_elem_value(*spec.coeff_arrays(u.device), u,
                                   uniform_op=spec.uniform_op).abs().sum(-1)
    assert bool(((lp - want_lp).abs() <= 1e-5 * abs_sum + 1e-6).all())
    again = lf_ops.potential_value_and_grad(spec, u)
    assert torch.equal(again[0], lp) and torch.equal(again[1], g)
    assert _counts_are_zero(torch.cuda.current_stream())
    for _ in range(3):
        lf_ops.fused_leapfrog(spec, u, p, g, 0.01, 4)
        got = lf_ops.potential_value_and_grad(spec, u)
        assert torch.equal(got[0], lp) and torch.equal(got[1], g)
    assert _counts_are_zero(torch.cuda.current_stream())
    _assert_one_kernel_a_call(lf_ops.potential_value_and_grad, (spec, u),
                              kernel="leapfrog_kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("table", list(LF_TABLES))
@pytest.mark.parametrize("dim", MAIN_DIMS + (8192,))
def test_cuda_fused_potential_vg_one_launch_matches_plain_version(
        cuda_device, table, dim):
    """4 chains (1 at 1,000,003 coordinates), dense rows: either side of
    one block, 2,047 and 2,049, family_mix_8k's 8,192 and gaussian_10k's
    10,000."""
    gen = torch.Generator(device=cuda_device).manual_seed(25)
    rows = 1 if dim == 1_000_003 else 4
    _assert_potential_one_launch(*_potential_state(table, rows, dim, "dense",
                                                   gen, cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("table", list(LF_TABLES))
@pytest.mark.parametrize("dim", [1, 257, 8192, 10000])
@pytest.mark.parametrize("layout", ["1-D", "row stride 0"])
def test_cuda_fused_potential_vg_one_launch_layouts(cuda_device, table, dim,
                                                    layout):
    """One chain as a 1-D u, and 4 chains sharing one row at row stride 0
    (whose potentials and gradients are then the dense row's bits in every
    chain)."""
    gen = torch.Generator(device=cuda_device).manual_seed(26)
    spec, u, p = _potential_state(table, 4, dim, layout, gen, cuda_device)
    _assert_potential_one_launch(spec, u, p)
    if layout == "row stride 0":
        lp, g = lf_ops.potential_value_and_grad(spec, u)
        lp1, g1 = lf_ops.potential_value_and_grad(spec, u[0].contiguous())
        assert all(torch.equal(v, lp1) for v in lp)
        assert all(torch.equal(r, g1) for r in g)


@pytest.mark.cuda
@pytest.mark.parametrize("table,rows,dim", [("normal", 4, 10000),
                                            ("runs", 4, 8192),
                                            ("normal", 1, 1_000_003)])
def test_cuda_fused_potential_vg_reruns_and_two_streams(cuda_device, table,
                                                        rows, dim):
    """The last-block merge: 100 back-to-back calls bit-identical, calls
    alternating between two streams equal to them, every count back at 0
    on each stream."""
    gen = torch.Generator(device=cuda_device).manual_seed(27)
    spec, u, _ = _potential_state(table, rows, dim, "dense", gen,
                                  cuda_device)

    def kern(u):
        lp, g = lf_ops.potential_value_and_grad(spec, u)
        return torch.cat([lp, g.reshape(-1)])

    _assert_reruns_and_two_streams(cuda_device, kern, (u,))


@pytest.mark.cuda
def test_cuda_fused_potential_vg_refuses_bad_plans(cuda_device):
    """The C side refuses parts that are not ceil(dim / LEAPFROG_SHARE) and
    a merge without scratch; the wrapper raises its error as
    KernelError."""
    from repro_torch.kernels._build import KernelError
    share = lf_ops.LEAPFROG_SHARE
    dim = 2 * share
    spec = lf_ref.random_spec(dim, OP_NORMAL)
    table = [t.data_ptr() for t in spec.coeff_arrays(cuda_device)]
    u = torch.zeros(4 * dim, device=cuda_device)
    g_out = torch.empty(4 * dim, device=cuda_device)
    out = torch.empty(4, device=cuda_device)
    partials = torch.empty(4 * 2, device=cuda_device)
    counts = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    fn = lf_ops._lib().repro_fused_potential_vg
    stream = torch.cuda.current_stream().cuda_stream

    def call(n, nparts, scratch=True):
        return fn(u.data_ptr(), n, *table, OP_NORMAL, 4, n, nparts,
                  g_out.data_ptr(), partials.data_ptr() if scratch else None,
                  counts.data_ptr() if scratch else None, -1.25,
                  out.data_ptr(), stream)

    assert call(dim, 2) == 0
    assert call(dim - 1, 2) == 0
    assert call(share, 1, scratch=False) == 0  # one block a chain
    torch.cuda.synchronize()
    assert not bool(counts.any())
    assert call(dim, 3) != 0                    # parts
    assert call(dim, 2, scratch=False) != 0     # a merge, no scratch
    err = call(dim, 1)
    with pytest.raises(KernelError, match="fused_potential_vg"):
        lf_ops._raise_on(err, "fused_potential_vg")


# ---------------------------------------------------------------------------
# flash attention and the SSD scan
# ---------------------------------------------------------------------------
def _rel_err(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / (b.abs().max() + 1e-6))


FLASH_CASES = [
    # B, Sq, Sk, KV, G, hd, causal, window, cap (tests/test_kernels.py's,
    # head dims 16 and 20, and the serving paths' shapes)
    (2, 128, 128, 2, 2, 64, True, None, None),
    (1, 256, 256, 1, 4, 128, True, None, 50.0),
    (2, 100, 100, 2, 1, 64, True, 64, None),
    (1, 64, 64, 4, 1, 128, False, None, None),
    (1, 1, 96, 2, 2, 64, True, None, None),
    (1, 8, 160, 1, 2, 256, True, 32, 30.0),
    (2, 40, 40, 2, 3, 16, True, None, None),
    (2, 33, 70, 1, 3, 20, True, 9, None),
    (8, 1, 1088, 5, 3, 64, True, None, None),
    (2, 1, 4096, 16, 2, 128, True, 4096, 50.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_flash_attention_matches_plain_version(cuda_device, case,
                                                    dtype):
    B, Sq, Sk, KV, G, hd, causal, window, cap = case
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
               for shape in ((B, Sq, KV, G, hd), (B, Sk, KV, hd),
                             (B, Sk, KV, hd)))
    qp = torch.arange(Sk - Sq, Sk, dtype=torch.int32,
                      device=cuda_device)[None].expand(B, Sq)
    kp = torch.arange(Sk, dtype=torch.int32, device=cuda_device)[None]
    kp = kp.expand(B, Sk)
    kw = dict(q_positions=qp, kv_positions=kp, causal=causal, window=window,
              cap=cap, kv_mask=kp < Sk - 3)
    flash_ops.reset_launch_counts()
    got = flash_ops.flash_attention_gqa(q, k, v, **kw)
    again = flash_ops.flash_attention_gqa(q, k, v, **kw)
    kernel = flash_ops.plan(B, Sq, Sk, KV, G, dtype, hd).kernel
    assert flash_ops.LAUNCHES == {**dict.fromkeys(flash_ops.KERNELS, 0),
                                  kernel: 2}
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, again)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    assert _rel_err(got, attention_ref(q, k, v, **kw)) < tol


@pytest.mark.cuda
def test_cuda_flash_attention_ring_masks_and_backward(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    B, Sk, KV, G, hd = 2, 64, 2, 2, 64
    q = torch.randn(B, 3, KV, G, hd, generator=gen, device=cuda_device)
    k = torch.randn(B, Sk, KV, hd, generator=gen, device=cuda_device)
    v = torch.randn(B, Sk, KV, hd, generator=gen, device=cuda_device)
    last = 100
    slot = torch.arange(Sk, dtype=torch.int32, device=cuda_device)
    kp = (last - torch.remainder(last - slot, Sk))[None].expand(B, Sk)
    qp = torch.tensor([[last, last - 1, -7]] * B, dtype=torch.int32,
                      device=cuda_device)
    mask = torch.ones(B, Sk, dtype=torch.bool, device=cuda_device)
    mask[:, 5:40:4] = False
    kw = dict(q_positions=qp, kv_positions=kp, causal=True, window=48,
              cap=None, kv_mask=mask)
    got = flash_ops.flash_attention_gqa(q, k, v, **kw)
    assert _rel_err(got, attention_ref(q, k, v, **kw)) < 2e-5
    assert bool((got[:, 2] == 0).all())  # a row before every key
    # backward: the autograd.Function against autograd of the plain version
    w = torch.randn(q.shape, generator=gen, device=cuda_device)
    grads = []
    for fn in (flash_ops.flash_attention_gqa, attention_ref):
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        (fn(*ins, **kw) * w).sum().backward()
        grads.append([t.grad for t in ins])
    for a, b in zip(*grads):
        assert _rel_err(a, b) < 2e-5


def _flash_inputs(dev, B, Sq, Sk, KV, G, hd, dtype, holes, seed):
    """q, k, v and a cache of Sk slots whose last Sq keys are the queries'
    own, every 13th slot a hole when ``holes``, the last slot invalid."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((B, Sq, KV, G, hd), (B, Sk, KV, hd),
                             (B, Sk, KV, hd)))
    kp = torch.arange(Sk, dtype=torch.int32, device=dev)
    ok = kp < Sk - 1
    if holes:
        ok = ok & (torch.remainder(kp, 13) != 5)
    return q, k, v, kp, ok


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("B,Sq,Sk,KV,G,window,cap", [
    (2, 100, 100, 2, 1, None, None),       # ragged rows, self-attention
    (1, 333, 517, 2, 3, None, 50.0),       # ragged Sq and Sk, softcap
    (2, 190, 1000, 1, 2, 128, 30.0),       # window and softcap
    (1, 64, 65, 4, 1, 7, None),            # one row tile, a narrow window
])
def test_cuda_flash_fwd_tc_matches_plain_version(cuda_device, hd, B, Sq, Sk,
                                                 KV, G, window, cap):
    q, k, v, kp, ok = _flash_inputs(cuda_device, B, Sq, Sk, KV, G, hd,
                                    torch.bfloat16, True, 8)
    # the first three queries come before every key: fully masked rows
    qp = torch.cat([torch.full((3,), -5, dtype=torch.int32,
                               device=cuda_device), kp[Sk - Sq + 3:]])
    kw = dict(q_positions=qp[None].expand(B, Sq),
              kv_positions=kp[None].expand(B, Sk), kv_mask=ok[None].expand(
                  B, Sk), causal=True, window=window, cap=cap)
    assert flash_ops.plan(B, Sq, Sk, KV, G, torch.bfloat16,
                          hd).kernel == "flash_fwd_tc"
    flash_ops.reset_launch_counts()
    got = flash_ops.flash_attention_gqa(q, k, v, **kw)
    again = flash_ops.flash_attention_gqa(q, k, v, **kw)
    assert flash_ops.LAUNCHES["flash_fwd_tc"] == 2
    assert torch.equal(got, again)
    assert bool((got[:, :3] == 0).all())
    assert _rel_err(got, attention_ref(q, k, v, **kw)) < 3e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("G", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("Sq,Sk,hd,window,cap", [
    (1, 77, 64, None, None),               # odd Sk
    (1, 1089, 128, 512, 50.0),             # split keys, window, softcap
    (2, 301, 64, None, 30.0),              # two query positions
])
def test_cuda_flash_decode_matches_plain_version(cuda_device, dtype, G, Sq,
                                                 Sk, hd, window, cap):
    B, KV = 2, 2
    q, k, v, kp, ok = _flash_inputs(cuda_device, B, Sq, Sk, KV, G, hd, dtype,
                                    True, 9)
    kw = dict(q_positions=kp[Sk - Sq:][None].expand(B, Sq),
              kv_positions=kp[None].expand(B, Sk),
              kv_mask=ok[None].expand(B, Sk), causal=True, window=window,
              cap=cap)
    assert flash_ops.plan(B, Sq, Sk, KV, G, dtype,
                          hd).kernel == "flash_decode"
    flash_ops.reset_launch_counts()
    got = flash_ops.flash_attention_gqa(q, k, v, **kw)
    again = flash_ops.flash_attention_gqa(q, k, v, **kw)
    assert flash_ops.LAUNCHES["flash_decode"] == 2
    assert torch.equal(got, again)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    assert _rel_err(got, attention_ref(q, k, v, **kw)) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3, 4, 5, 20, 99, 100, 256, 257])
@pytest.mark.parametrize("rows,n", [(1, 1), (4, 99), (4, 10176)])
def test_cuda_categorical_small_c_path_matches_plain_version(cuda_device, c,
                                                             rows, n):
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    logits = 3.0 * torch.randn(rows, n, c, generator=gen, device=cuda_device)
    labels = torch.randint(0, c, (rows, n), generator=gen,
                           device=cuda_device, dtype=torch.int32)
    ops.reset_launch_counts()
    got = ops.categorical_logits_sum_rows(logits, labels)
    path = ("categorical_logits_sum_small" if c <= 256
            else "categorical_logits_sum")
    assert ops.LAUNCHES == {**dict.fromkeys(ops.LAUNCHES, 0), path: 1}
    torch.testing.assert_close(
        got, ref.categorical_logits_logpmf_sum_ref(logits, labels),
        rtol=1e-6, atol=0)
    assert torch.equal(ops.categorical_logits_sum_rows(logits, labels), got)


SSD_CASES = [
    # b, s, h, p, g, n, chunk (tests/test_kernels.py's and mamba2-1.3b's)
    (2, 256, 4, 64, 1, 128, 128),
    (1, 200, 8, 64, 2, 128, 64),
    (1, 256, 4, 64, 4, 32, 128),
    (2, 64, 2, 32, 1, 16, 32),
    (1, 77, 4, 32, 2, 16, 32),
    (4, 2048, 64, 64, 1, 128, 128),
    # ssd_scan_tc at p 128, n 64, chunk 64 and ragged lengths
    (1, 77, 2, 128, 1, 64, 128),
    (2, 300, 4, 128, 2, 128, 64),
    (1, 130, 4, 64, 2, 64, 64),
]


def _ssd_inputs(case, dtype, dev, seed=7):
    b, s, h, p, g, n, _ = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, s, h, p, generator=gen, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=gen,
                                                  device=dev))
    A = -torch.exp(0.5 * torch.randn(h, generator=gen, device=dev))
    B = torch.randn(b, s, g, n, generator=gen, device=dev).to(dtype)
    C = torch.randn(b, s, g, n, generator=gen, device=dev).to(dtype)
    return x, dt, A, B, C


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_ssd_scan_matches_plain_version(cuda_device, case, dtype):
    ins = _ssd_inputs(case, dtype, cuda_device)
    chunk = case[-1]
    b, s, h, p, g, n, _ = case
    kernel = ssd_ops.plan(h, g, p, n, chunk, dtype)
    ssd_ops.reset_launch_counts()
    got = ssd_ops.ssd_scan(*ins, chunk=chunk)
    again = ssd_ops.ssd_scan(*ins, chunk=chunk)
    assert ssd_ops.LAUNCHES == {**dict.fromkeys(ssd_ops.KERNELS, 0),
                                kernel: 2}
    assert got.dtype == dtype and torch.equal(got, again)
    tol = 2e-4 if dtype == torch.float32 else 5e-2
    assert _rel_err(got, ssd_scan_ref(*ins, chunk=chunk)) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in SSD_CASES
                                  if ssd_ops.plan(c[2], c[4], c[3], c[5],
                                                  c[6]) == "ssd_scan_tc"])
def test_cuda_ssd_scan_both_kernels_on_bf16(cuda_device, case):
    """Where plan picks ssd_scan_tc, the FP32 kernel takes the same bf16
    call too: both within 5e-2 of the plain version, each bit-identical on
    a rerun."""
    ins = _ssd_inputs(case, torch.bfloat16, cuda_device)
    want = ssd_scan_ref(*ins, chunk=case[-1])
    for kernel in ("ssd_scan", "ssd_scan_tc"):
        got = ssd_ops.launch_kernel(kernel, *ins, chunk=case[-1])
        assert torch.equal(ssd_ops.launch_kernel(kernel, *ins,
                                                 chunk=case[-1]), got)
        assert _rel_err(got, want) < 5e-2


@pytest.mark.cuda
@pytest.mark.parametrize("p,g", [(64, 1), (128, 2)])
def test_cuda_ssd_scan_tc_reads_the_mixers_views(cuda_device, p, g):
    """x, B and C as the mixer passes them: views of one convolution
    output (row stride h p + 2 g n), read through their strides by
    ssd_scan_tc, nothing copied."""
    b, s, h, n = 2, 200, 4, 128
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    conv = torch.randn(b, s, h * p + 2 * g * n, generator=gen,
                       device=cuda_device).to(torch.bfloat16)
    xs, Bc, Cc = torch.split(conv, [h * p, g * n, g * n], dim=-1)
    x, B, C = (xs.reshape(b, s, h, p), Bc.reshape(b, s, g, n),
               Cc.reshape(b, s, g, n))
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=gen,
                                                  device=cuda_device))
    A = -torch.exp(0.5 * torch.randn(h, generator=gen, device=cuda_device))
    ssd_ops.reset_launch_counts()
    got = ssd_ops.ssd_scan(x, dt, A, B, C, chunk=128)
    assert ssd_ops.LAUNCHES == {**dict.fromkeys(ssd_ops.KERNELS, 0),
                                "ssd_scan_tc": 1}
    assert _rel_err(got, ssd_scan_ref(x, dt, A, B, C, chunk=128)) < 5e-2


@pytest.mark.cuda
def test_cuda_ssd_scan_chunk_invariance_and_backward(cuda_device):
    ins = _ssd_inputs((1, 128, 2, 32, 1, 64, 32), torch.float32, cuda_device)
    y32 = ssd_ops.ssd_scan(*ins, chunk=32)
    y64 = ssd_ops.ssd_scan(*ins, chunk=64)
    assert _rel_err(y32, y64) < 1e-4
    w = torch.randn_like(y32)
    grads = []
    for fn in (ssd_ops.ssd_scan, ssd_scan_ref):
        xs = [t.clone().requires_grad_(True) for t in ins]
        (fn(*xs, chunk=32) * w).sum().backward()
        grads.append([t.grad for t in xs])
    for a, b in zip(*grads):
        assert _rel_err(a, b) < 2e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_and_ssd_functions_under_torch_func_grad(cuda_device,
                                                            dtype):
    """The flash-attention and SSD autograd Functions (torch.func's form)
    under ``torch.func.grad`` of a fixed weighting of their outputs: the
    forward launches the kernel once, the backward recomputes through the
    plain version (no launch), and the gradients equal ``torch.autograd``
    through the Function bit for bit (the same backward) and through the
    plain version within the kernels' float32 tolerance (their backward is
    the plain version's)."""
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    q = torch.randn(2, 256, 2, 3, 64, generator=gen, device=cuda_device)
    k, v = (torch.randn(2, 256, 2, 64, generator=gen, device=cuda_device)
            for _ in range(2))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    w = torch.randn(q.shape, generator=gen, device=cuda_device)
    pos = torch.arange(256, dtype=torch.int32, device=cuda_device)
    kw = dict(q_positions=pos[None].expand(2, 256),
              kv_positions=pos[None].expand(2, 256), causal=True,
              window=None, cap=None)

    def loss(fn):
        return lambda q, k, v: (fn(q, k, v, **kw).float() * w).sum()

    flash_ops.reset_launch_counts()
    got = torch.func.grad(loss(flash_ops.flash_attention_gqa),
                          argnums=(0, 1, 2))(q, k, v)
    assert sum(flash_ops.LAUNCHES.values()) == 1
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    again = torch.autograd.grad(loss(flash_ops.flash_attention_gqa)(*ins),
                                ins)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    plain = torch.autograd.grad(loss(attention_ref)(*ins), ins)
    for a, b, c in zip(got, again, plain):
        assert torch.equal(a, b)
        assert _rel_err(a, c) < 2e-5
    ins = _ssd_inputs((2, 256, 4, 64, 1, 64, 64), dtype, cuda_device)
    w = torch.randn(ins[0].shape, generator=gen, device=cuda_device)

    def sloss(fn):
        return lambda *a: (fn(*a, chunk=64).float() * w).sum()

    ssd_ops.reset_launch_counts()
    got = torch.func.grad(sloss(ssd_ops.ssd_scan),
                          argnums=(0, 1, 2, 3, 4))(*ins)
    assert sum(ssd_ops.LAUNCHES.values()) == 1
    xs = [t.clone().requires_grad_(True) for t in ins]
    again = torch.autograd.grad(sloss(ssd_ops.ssd_scan)(*xs), xs)
    xs = [t.clone().requires_grad_(True) for t in ins]
    plain = torch.autograd.grad(sloss(ssd_scan_ref)(*xs), xs)
    for a, b, c in zip(got, again, plain):
        assert torch.equal(a, b)
        assert _rel_err(a, c) < 2e-4


@pytest.mark.cuda
def test_cuda_bf16_logits_product_and_its_backward(cuda_device):
    """The LM's bf16 logits on the card (``nn.common.f32_product``): a
    float32 result equal to the float32 product of the bf16 operands
    within float32 summation order, and a backward (the cotangent rounded
    to bf16, float32 accumulation, one rounding to bf16) within bf16's
    2^-8 of the float32 gradients' max, under autograd and torch.func."""
    from repro_torch.nn.common import f32_product
    gen = torch.Generator(device=cuda_device).manual_seed(22)
    x = torch.randn(2, 64, 96, generator=gen, device=cuda_device)
    table = torch.randn(1000, 96, generator=gen, device=cuda_device)
    xb, tb = x.bfloat16(), table.bfloat16()
    w = torch.randn(2, 64, 1000, generator=gen, device=cuda_device)
    out = f32_product(xb, tb)
    assert out.dtype == torch.float32
    assert _rel_err(out, xb.float() @ tb.float().T) < 1e-5
    ins = [t.clone().requires_grad_(True) for t in (xb, tb)]
    got = torch.autograd.grad((f32_product(*ins) * w).sum(), ins)
    ins = [t.float().requires_grad_(True) for t in (xb, tb)]
    want = torch.autograd.grad(((ins[0] @ ins[1].T) * w).sum(), ins)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and _rel_err(a, b) < 2 ** -8
    fgot = torch.func.grad(lambda a, b: (f32_product(a, b) * w).sum(),
                           argnums=(0, 1))(xb, tb)
    for a, b in zip(fgot, got):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the float32 tensor-core kernels: flash_fwd_tf32 and ssd_scan_tf32 (3xTF32)
# ---------------------------------------------------------------------------
# (B, Sq, Sk, KV, G, hd, window, cap, holes): the float32 prefill at hd 64
# and 128: test_kernels.py's cases, ragged Sq and Sk, windows, softcaps,
# holes, splits (few blocks), and smollm's and gemma2's calls
TF32_FLASH_CASES = [
    (2, 128, 128, 2, 2, 64, None, None, False),
    (1, 256, 256, 1, 4, 128, None, 50.0, False),
    (2, 100, 100, 2, 1, 64, 64, None, True),
    (1, 64, 64, 4, 1, 128, None, None, False),
    (1, 333, 517, 2, 3, 64, None, 50.0, True),
    (2, 190, 1000, 1, 2, 128, 128, 30.0, True),
    (1, 64, 65, 4, 1, 64, 7, None, True),
    (2, 97, 97, 1, 2, 128, 17, None, True),
    (8, 1024, 1088, 5, 3, 64, None, None, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", TF32_FLASH_CASES)
def test_cuda_flash_fwd_tf32_matches_plain_version(cuda_device, case):
    """flash_fwd_tf32 against the plain version at 2e-5 of max|plain| (the
    float32 gate), the first three queries before every key (exactly-zero
    rows), a bit-identical rerun, and the FP32 flash_fwd on the same call
    by launch_kernel."""
    B, Sq, Sk, KV, G, hd, window, cap, holes = case
    q, k, v, kp, ok = _flash_inputs(cuda_device, B, Sq, Sk, KV, G, hd,
                                    torch.float32, holes, 10)
    qp = torch.cat([torch.full((3,), -5, dtype=torch.int32,
                               device=cuda_device), kp[Sk - Sq + 3:]])
    kw = dict(q_positions=qp[None].expand(B, Sq),
              kv_positions=kp[None].expand(B, Sk), kv_mask=ok[None].expand(
                  B, Sk), causal=True, window=window, cap=cap)
    assert flash_ops.plan(B, Sq, Sk, KV, G, torch.float32,
                          hd).kernel == "flash_fwd_tf32"
    flash_ops.reset_launch_counts()
    got = flash_ops.flash_attention_gqa(q, k, v, **kw)
    again = flash_ops.flash_attention_gqa(q, k, v, **kw)
    assert flash_ops.LAUNCHES == {**dict.fromkeys(flash_ops.KERNELS, 0),
                                  "flash_fwd_tf32": 2}
    assert got.dtype == torch.float32 and torch.equal(got, again)
    assert bool((got[:, :3] == 0).all())
    want = attention_ref(q, k, v, **kw)
    assert _rel_err(got, want) < 2e-5
    old = flash_ops.launch_kernel("flash_fwd", q, k, v, **kw)
    assert _rel_err(old, want) < 2e-5


@pytest.mark.cuda
def test_cuda_flash_fwd_tf32_ring_with_holes(cuda_device):
    """A ring of positions with holes and a query before every key,
    through flash_fwd_tf32 (70 rows): rel 2e-5, the masked row exactly 0."""
    gen = torch.Generator(device=cuda_device).manual_seed(17)
    B, Sq, Sk, KV, G, hd, last = 2, 35, 64, 2, 2, 64, 100
    q = torch.randn(B, Sq, KV, G, hd, generator=gen, device=cuda_device)
    k = torch.randn(B, Sk, KV, hd, generator=gen, device=cuda_device)
    v = torch.randn(B, Sk, KV, hd, generator=gen, device=cuda_device)
    slot = torch.arange(Sk, dtype=torch.int32, device=cuda_device)
    ok = torch.ones(B, Sk, dtype=torch.bool, device=cuda_device)
    ok[:, 5:40:4] = False
    qpos = torch.tensor([last, last - 1, -7] + [last - 2 - i
                                                for i in range(Sq - 3)],
                        dtype=torch.int32, device=cuda_device)
    kw = dict(q_positions=qpos[None].expand(B, Sq),
              kv_positions=(last - torch.remainder(last - slot, Sk))[None]
              .expand(B, Sk), kv_mask=ok, causal=True, window=48, cap=None)
    assert flash_ops.plan(B, Sq, Sk, KV, G, torch.float32,
                          hd).kernel == "flash_fwd_tf32"
    got = flash_ops.flash_attention_gqa(q, k, v, **kw)
    assert _rel_err(got, attention_ref(q, k, v, **kw)) < 2e-5
    assert bool((got[:, 2] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,KV,G,hd", [(8, 1024, 1088, 5, 3, 64),
                                            (1, 333, 517, 2, 3, 64),
                                            (2, 190, 1000, 1, 2, 128)])
def test_cuda_flash_fwd_tf32_kernels_a_call_by_profiler(cuda_device, B, Sq,
                                                       Sk, KV, G, hd):
    """One flash_tiles and one flash_fwd_tf32 a call, and one
    flash_combine where plan splits the keys, nothing else, by the nodes
    of a CUDA graph of 10 calls."""
    q, k, v, kp, ok = _flash_inputs(cuda_device, B, Sq, Sk, KV, G, hd,
                                    torch.float32, True, 11)
    kw = dict(q_positions=kp[Sk - Sq:][None].expand(B, Sq),
              kv_positions=kp[None].expand(B, Sk),
              kv_mask=ok[None].expand(B, Sk), causal=True, window=None,
              cap=None)
    nsplit = flash_ops.plan(B, Sq, Sk, KV, G, torch.float32, hd).nsplit
    names = _graph_kernels(
        lambda: flash_ops.flash_attention_gqa(q, k, v, **kw))
    want = {"flash_tiles": 10, "flash_fwd_tf32": 10,
            "flash_combine": 10 if nsplit > 1 else 0}
    assert {n: sum(n in k for k in names) for n in want} == want, names
    assert len(names) == sum(want.values()), names


def _tf32_ssd_cases():
    return [c for c in SSD_CASES
            if ssd_ops.plan(c[2], c[4], c[3], c[5], c[6], torch.float32)
            == "ssd_scan_tf32"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _tf32_ssd_cases())
def test_cuda_ssd_scan_tf32_matches_plain_version(cuda_device, case):
    """ssd_scan_tf32 on every float32 call of SSD_CASES that plan sends it
    (mamba2's among them) against the plain version at 2e-4, bit-identical
    on a rerun; the FP32 kernel on the same call by launch_kernel."""
    ins = _ssd_inputs(case, torch.float32, cuda_device, seed=13)
    chunk = case[-1]
    want = ssd_scan_ref(*ins, chunk=chunk)
    ssd_ops.reset_launch_counts()
    got = ssd_ops.ssd_scan(*ins, chunk=chunk)
    again = ssd_ops.ssd_scan(*ins, chunk=chunk)
    assert ssd_ops.LAUNCHES == {**dict.fromkeys(ssd_ops.KERNELS, 0),
                                "ssd_scan_tf32": 2}
    assert torch.equal(got, again)
    assert _rel_err(got, want) < 2e-4
    old = ssd_ops.launch_kernel("ssd_scan", *ins, chunk=chunk)
    assert _rel_err(old, want) < 2e-4


@pytest.mark.cuda
def test_cuda_ssd_scan_tf32_chunk_invariance_and_views(cuda_device):
    """ssd_scan_tf32 walks sub-chunks of 64 whatever the chunk: chunk 32,
    64 and 128 give the same bits, within 1e-4 of the FP32 kernel at chunk
    32; the mixer's float32 views go through it as they are; the backward
    (through the plain version) at 2e-4."""
    ins = _ssd_inputs((1, 300, 2, 64, 1, 64, 64), torch.float32,
                      cuda_device, seed=15)
    ssd_ops.reset_launch_counts()
    y32, y64, y128 = (ssd_ops.ssd_scan(*ins, chunk=c) for c in ssd_ops.CHUNKS)
    assert ssd_ops.LAUNCHES == {**dict.fromkeys(ssd_ops.KERNELS, 0),
                                "ssd_scan_tf32": 3}
    assert torch.equal(y32, y64) and torch.equal(y64, y128)
    assert _rel_err(y128, ssd_ops.launch_kernel("ssd_scan", *ins,
                                                chunk=32)) < 1e-4
    w = torch.randn_like(y64)
    grads = []
    for fn in (ssd_ops.ssd_scan, ssd_scan_ref):
        xs = [t.clone().requires_grad_(True) for t in ins]
        (fn(*xs, chunk=64) * w).sum().backward()
        grads.append([t.grad for t in xs])
    for a, b in zip(*grads):
        assert _rel_err(a, b) < 2e-4
    b, s, h, p, g, n = 2, 200, 4, 128, 2, 64
    gen = torch.Generator(device=cuda_device).manual_seed(16)
    conv = torch.randn(b, s, h * p + 2 * g * n, generator=gen,
                       device=cuda_device)
    xs, Bc, Cc = torch.split(conv, [h * p, g * n, g * n], dim=-1)
    x, B, C = (xs.reshape(b, s, h, p), Bc.reshape(b, s, g, n),
               Cc.reshape(b, s, g, n))
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=gen,
                                                  device=cuda_device))
    A = -torch.exp(0.5 * torch.randn(h, generator=gen, device=cuda_device))
    ssd_ops.reset_launch_counts()
    got = ssd_ops.ssd_scan(x, dt, A, B, C, chunk=128)
    assert ssd_ops.LAUNCHES == {**dict.fromkeys(ssd_ops.KERNELS, 0),
                                "ssd_scan_tf32": 1}
    assert _rel_err(got, ssd_scan_ref(x, dt, A, B, C, chunk=128)) < 2e-4


@pytest.mark.cuda
def test_cuda_ssd_scan_tf32_one_kernel_by_profiler(cuda_device):
    """One ssd_scan_tf32 kernel and its pre-pass (ssd_scan_tf32_gram, G =
    C B^T once for a group's heads) a call at mamba2's float32 call, by
    the nodes of a CUDA graph of 4 calls."""
    ins = _ssd_inputs((4, 2048, 64, 64, 1, 128, 128), torch.float32,
                      cuda_device)
    names = _graph_kernels(lambda: ssd_ops.ssd_scan(*ins, chunk=128),
                           calls=4)
    assert sum("ssd_scan_tf32_gram<" in k for k in names) == 4, names
    assert sum("ssd_scan_tf32<" in k for k in names) == 4, names
    assert len(names) == 8, names


# bernoulli_logit_sum as logreg calls it (logits a row a chain, y shared by
# the chains at row stride 0), with the logits as an offset view (4-byte
# loads), one element, and a row of many blocks
BERNOULLI_CASES = [(4, 10000, "aligned"), (4, 10000, "offset"),
                   (1, 1, "aligned"), (1, 1_000_003, "aligned")]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,layout", BERNOULLI_CASES)
def test_cuda_bernoulli_one_launch_on_logregs_layout(cuda_device, rows, n,
                                                     layout):
    """rtol 1e-6 against the plain version, the plan's load width, one
    launch a call, a bit-identical rerun and the counts back at 0 (one
    row_sum kernel a call by a CUDA graph's nodes at these shapes:
    ``test_cuda_one_launch_is_one_kernel_by_profiler``)."""
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    logits = _rows(rows, n, gen, cuda_device,
                   "offset" if layout == "offset" else "aligned", scale=2.0,
                   randn=True)
    y = _rows(rows, n, gen, cuda_device, layout="shared", coin=True)
    kern, args = ops.bernoulli_logit_sum_rows, (logits, y)
    want = ref.bernoulli_logits_logpmf_sum_ref(logits, y)
    plan = _plan_of(args, rows, n, "bernoulli_logit_sum")
    assert plan.vec == (layout != "offset" or n == 1)
    ops.reset_launch_counts()
    got = kern(*args)
    assert ops.LAUNCHES == {**dict.fromkeys(ops.LAUNCHES, 0),
                            "bernoulli_logit_sum": 1}
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    assert torch.equal(kern(*args), got)
    assert _counts_are_zero(torch.cuda.current_stream())


# categorical_logits_sum above 256 classes: one launch, each logit read
# once; 257 and 4,097 take 4-byte loads (C not a multiple of 4), the LM
# vocabularies 16-byte ones
CAT_LARGE_C = (257, 1000, 4097, 49152, 50280)


def _cat_logits(rows, n, c, gen, dev, offset=False, scale=3.0):
    """``(rows, n, c)`` logits: fresh, or a view one float past a 16-byte
    boundary (4-byte loads at any C)."""
    flat = scale * torch.randn(rows * n * c + offset, generator=gen,
                               device=dev)
    return flat[int(offset):].view(rows, n, c)


@pytest.mark.cuda
@pytest.mark.parametrize("c", CAT_LARGE_C)
@pytest.mark.parametrize("rows,n", [(1, 1), (4, 99), (16, 257), (1, 8192)])
@pytest.mark.parametrize("labels", ["shared", "per_row"])
@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
def test_cuda_categorical_large_c_one_launch(cuda_device, c, rows, n, labels,
                                             offset):
    """rtol 1e-6 against the plain version (every term is <= 0), one
    launch a call, the plan's load width, a bit-identical rerun, and the
    counts back at 0."""
    gen = torch.Generator(device=cuda_device).manual_seed(22)
    logits = _cat_logits(rows, n, c, gen, cuda_device, offset)
    lab = torch.randint(0, c, (n,) if labels == "shared" else (rows, n),
                        generator=gen, device=cuda_device,
                        dtype=torch.int32).expand(rows, n)
    plan = ops.categorical_plan(n, c, logits.data_ptr(),
                                logits.stride(0) if rows > 1 else 0)
    assert plan == ops.ReducePlan(min(1024, -(-n // ops.CAT_ITEMS)),
                                  c % 4 == 0 and not offset)
    ops.reset_launch_counts()
    got = ops.categorical_logits_sum_rows(logits, lab)
    assert ops.LAUNCHES == {**dict.fromkeys(ops.LAUNCHES, 0),
                            "categorical_logits_sum": 1}
    torch.testing.assert_close(
        got, ref.categorical_logits_logpmf_sum_ref(logits, lab), rtol=1e-6,
        atol=0)
    assert torch.equal(ops.categorical_logits_sum_rows(logits, lab), got)
    assert _counts_are_zero(torch.cuda.current_stream())


@pytest.mark.cuda
@pytest.mark.parametrize("c", CAT_LARGE_C)
@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
def test_cuda_categorical_large_c_edges(cuda_device, c, offset):
    """log_softmax's edges, one item a row so that each is held alone:
    -inf entries add 0 (at the start of every lane's classes too), a label
    on a -inf entry gives -inf, a row of -inf gives NaN, a +inf or NaN
    logit gives NaN, labels -1 and C give NaN; and the same entries summed
    over items. NaN and -inf where the plain version gives them, the rest
    at rtol 1e-6, bit-identical on a rerun."""
    gen = torch.Generator(device=cuda_device).manual_seed(23)
    ninf = float("-inf")
    logits = _cat_logits(11, 1, c, gen, cuda_device, offset, scale=1.0)
    lab = [0, 1, 3, 2, 4, 5, 6, -1, c, c - 1, c // 2]
    logits[1, 0, ::3] = ninf           # -inf entries, label 1 finite
    logits[2, 0, ::3] = ninf           # label 3 on a -inf entry
    logits[3, 0, :] = ninf             # a row of -inf
    logits[4, 0, c - 1] = float("inf")
    logits[5, 0, 5] = float("nan")
    logits[9, 0, :min(c - 1, 2048)] = ninf  # each lane's first classes
    logits[10, 0, 0] = ninf
    labels = torch.tensor(lab, dtype=torch.int32,
                          device=cuda_device).view(11, 1)
    got = ops.categorical_logits_sum_rows(logits, labels)
    want = ref.categorical_logits_logpmf_sum_ref(logits, labels)
    assert torch.isnan(want[[3, 4, 5, 7, 8]]).all()
    assert want[2] == ninf and torch.isfinite(want[[0, 1, 6, 9, 10]]).all()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0, equal_nan=True)
    assert torch.equal(got.view(torch.int32),
                       ops.categorical_logits_sum_rows(
                           logits, labels).view(torch.int32))
    # summed over items (the logits shared by the rows, row stride 0): every
    # row NaN over all eleven items; -inf, -inf and finite over the six
    # items without a NaN
    items = logits.view(1, 11, c).expand(3, 11, c)
    per_row = torch.tensor([lab, [0, 1, 3] + [0] * 8,
                            [0, 1, 1, 0, 0, 0, 6, 0, 0, c - 1, c - 1]],
                           dtype=torch.int32, device=cuda_device)
    keep = torch.tensor([0, 1, 2, 6, 9, 10], device=cuda_device)
    sub = items[:, keep].contiguous()
    for lg, lb in ((items, per_row), (sub, per_row[:, keep].contiguous())):
        want = ref.categorical_logits_logpmf_sum_ref(lg, lb)
        torch.testing.assert_close(ops.categorical_logits_sum_rows(lg, lb),
                                   want, rtol=1e-6, atol=0, equal_nan=True)
    assert want[0] == want[1] == ninf and torch.isfinite(want[2])


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,c", [(4, 99, 1000), (1, 8192, 49152),
                                      (1, 8192, 50280), (2, 8192, 4097)])
def test_cuda_categorical_large_c_reruns_streams_and_one_kernel(
        cuda_device, rows, n, c):
    """100 reruns bit-identical, calls on two streams equal to them with
    every count back at 0, and one categorical_sum kernel a call by the
    profiler."""
    gen = torch.Generator(device=cuda_device).manual_seed(24)
    logits = _cat_logits(rows, n, c, gen, cuda_device)
    lab = torch.randint(0, c, (rows, n), generator=gen, device=cuda_device,
                        dtype=torch.int32)
    args = (logits, lab)
    _assert_reruns_and_two_streams(cuda_device, ops.categorical_logits_sum_rows,
                                   args)
    _assert_one_kernel_a_call(ops.categorical_logits_sum_rows, args,
                              kernel="categorical_sum")


@pytest.mark.cuda
def test_cuda_categorical_refuses_bad_plans(cuda_device):
    """The C side refuses 16-byte loads at a C that is not a multiple of 4
    or on unaligned logits, parts that are not ceil(n / CAT_ITEMS) capped
    at 1,024, and a merge without scratch; the wrapper raises the error as
    KernelError."""
    from repro_torch.kernels._build import KernelError
    fn = ops._lib().repro_categorical_logits_sum
    logits = torch.zeros(2 * 64 * 1000 + 1, device=cuda_device)
    labels = torch.zeros(2, 64, dtype=torch.int32, device=cuda_device)
    out = torch.empty(2, device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    a, y = logits.data_ptr(), labels.data_ptr()

    def call(addr, c, n, nparts, vec, scratch=None):
        return fn(addr, n * c, y, 64, 2, n, c, nparts, vec, scratch, scratch,
                  out.data_ptr(), stream)

    assert call(a, 1000, 1, 1, 1) == 0
    assert call(a, 999, 1, 1, 1) != 0      # C not a multiple of 4
    assert call(a + 4, 1000, 1, 1, 1) != 0  # unaligned
    assert call(a + 4, 999, 1, 1, 0) == 0   # 4-byte loads take either
    assert call(a, 1000, 64, 7, 1) != 0     # ceil(64 / 8) is 8
    err = call(a, 1000, 64, 8, 1)           # a merge without scratch
    assert err != 0
    torch.cuda.synchronize()
    with pytest.raises(KernelError, match="categorical_logits_sum"):
        ops._raise_on(err, "categorical_logits_sum")


# ---------------------------------------------------------------------------
# the samplers' paths: NUTS leaves, and grad of a vmap (ADVI's order)
# ---------------------------------------------------------------------------
def _gaussian_nuts_step(dev, chains=4):
    """One NUTS step function on gaussian_10k's compiled spec (4 chains,
    jittered starts), its state, and the spec; each call of the returned
    ``one()`` redraws the same tree (its generator reseeded)."""
    from repro_torch.core.potential import compile_potential
    from repro_torch.infer import NUTS
    from repro_torch.models import paper_suite

    pm = paper_suite.build("gaussian_10k", device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    tvi = pm.model.typed_varinfo(gen).link()
    spec = compile_potential(pm.model, tvi).spec
    assert spec is not None
    kern = NUTS(step_size=0.1).make_kernel(pm.model.make_logdensity_fn(tvi),
                                           spec.dim, spec=spec)
    q0 = tvi.flat() + 2.0 * torch.rand((chains, spec.dim), generator=gen,
                                       device=dev) - 1.0
    state = kern.init(q0)

    def one():
        gen.manual_seed(5)
        return kern.step(state, gen)

    return one


@pytest.mark.cuda
def test_cuda_nuts_draw_is_one_potential_launch_a_leaf_iteration(cuda_device):
    """One NUTS draw on gaussian_10k's spec launches fused_potential_vg
    exactly once per lockstep leaf iteration for all chains together (the
    count the step reports in TREE_COUNTS), by LAUNCHES and by the
    profiler, and nothing else of the port."""
    from repro_torch.infer import nuts as nuts_mod
    one = _gaussian_nuts_step(cuda_device)
    one()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    lf_ops.reset_launch_counts()
    nuts_mod.reset_tree_counts()
    _, out = one()
    torch.cuda.synchronize()
    leaves = nuts_mod.TREE_COUNTS["last_leaf_iterations"]
    assert nuts_mod.TREE_COUNTS["trees"] == 1 and leaves >= 1
    assert leaves == nuts_mod.TREE_COUNTS["leaf_iterations"]
    assert lf_ops.LAUNCHES == {"fused_leapfrog": 0,
                               "fused_potential_vg": leaves}
    assert set(ops.LAUNCHES.values()) == {0}
    # a tree of depth d has at most 2^d - 1 leaves, and the deepest chain's
    # tree sets the lockstep count
    depth = int(out["tree_depth"].max())
    assert 2 ** (depth - 1) <= leaves <= 2 ** depth - 1
    windows = _kernel_windows(one, calls=3, per_call=leaves,
                              only="leapfrog_kernel")
    assert len(windows[-1]) == 3 * leaves, [len(w) for w in windows]


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["std_normal", "bernoulli", "gamma"])
def test_cuda_grad_of_vmap_matches_plain(cuda_device, family):
    """ADVI's transform order: ``grad`` of a ``vmap`` over 8 draws through
    the wrapper's autograd Function equals the same through the plain
    version at rtol 1e-5, with one forward launch for the 8 rows."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    n = 10000
    eps = torch.randn(8, n, generator=gen, device=cuda_device)
    y = (torch.rand(n, generator=gen, device=cuda_device) < 0.5).float()
    am1 = torch.full((n,), 1.5, device=cuda_device)
    rate = torch.full((n,), 0.7, device=cuda_device)
    fns = {"std_normal": (ops.std_normal_logpdf_sum,
                          ref.std_normal_logpdf_sum_ref, lambda u: (u,)),
           "bernoulli": (ops.bernoulli_logits_logpmf_sum,
                         ref.bernoulli_logits_logpmf_sum_ref,
                         lambda u: (u, y)),
           "gamma": (ops.gamma_unnorm_logpdf_sum,
                     ref.gamma_unnorm_logpdf_sum_ref,
                     lambda u: (torch.exp(u), am1, rate))}
    kern, plain, args = fns[family]

    def elbo(fn):
        def f(params):
            mu, log_sigma = params
            u = mu + torch.exp(log_sigma) * eps
            return torch.mean(torch.func.vmap(lambda uu: fn(*args(uu)))(u))
        return f

    params = (0.1 * torch.randn(n, generator=gen, device=cuda_device),
              torch.full((n,), -1.0, device=cuda_device))
    ops.reset_launch_counts()
    (gm, gs), v = torch.func.grad_and_value(elbo(kern))(params)
    kernel = {"std_normal": "std_normal_sum", "bernoulli":
              "bernoulli_logit_sum", "gamma": "gamma_unnorm_sum"}[family]
    assert ops.LAUNCHES == {**dict.fromkeys(ops.LAUNCHES, 0), kernel: 1}
    (wm, ws), wv = torch.func.grad_and_value(elbo(plain))(params)
    torch.testing.assert_close(v, wv, rtol=1e-5, atol=0)
    for g, w in ((gm, wm), (gs, ws)):
        torch.testing.assert_close(g, w, rtol=1e-5,
                                   atol=1e-5 * float(w.abs().max()))


# ---------------------------------------------------------------------------
# the compile step: programs captured as CUDA graphs against the same runs
# under disable_capture() (-k graph). The kernels are deterministic and the
# generator is registered with each graph, so every draw is identical.
# ---------------------------------------------------------------------------
def _same(a, b) -> bool:
    import numpy as np

    from repro_torch.infer.chains import Chain
    if isinstance(a, Chain):
        return (a.names() == b.names()
                and all(_same(a[k], b[k]) for k in a.names())
                and all(_same(a.stats[k], b.stats[k]) for k in a.stats))
    if isinstance(a, (tuple, list)):
        return all(_same(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        a, b = a.cpu().numpy(), b.cpu().numpy()
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and bool(np.array_equal(
        a, b, equal_nan=a.dtype.kind == "f"))


def _launches():
    return {**ops.LAUNCHES, **lf_ops.LAUNCHES, **flash_ops.LAUNCHES}


def _captured_and_eager(fn, warm=None):
    """``fn()`` captured, then under disable_capture(), with the launch
    counts of each; asserts graphs were replayed in the first. ``warm()``
    runs eagerly before both: what only a first run builds (the cached
    density and spec, whose compiler probes launch kernels)."""
    from repro_torch.core.program import GRAPH_COUNTS, disable_capture
    if warm is not None:
        with disable_capture():
            warm()
    for m in (ops, lf_ops, flash_ops):
        m.reset_launch_counts()
    replays = GRAPH_COUNTS["replays"]
    got = fn()
    torch.cuda.synchronize()
    assert GRAPH_COUNTS["replays"] > replays
    counted = _launches()
    for m in (ops, lf_ops, flash_ops):
        m.reset_launch_counts()
    with disable_capture():
        want = fn()
    torch.cuda.synchronize()
    return got, want, counted, _launches()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gaussian_10k", "logreg", "hier_poisson"])
def test_cuda_graph_run_chains_matches_eager(cuda_device, name):
    """run_chains with dual-averaging warmup: gaussian_10k on the fused
    leapfrog, logreg and hier_poisson on the autodiff integrator; the same
    draws, and after the replays the same launch counts, as eagerly."""
    from repro_torch.infer import HMC, run_chains
    from repro_torch.models import paper_suite

    pm = paper_suite.build(name, device=cuda_device)
    kernel = HMC(step_size=pm.step_size, n_leapfrog=pm.n_leapfrog,
                 adapt_step_size=True)
    def run(n=8, w=6):
        return run_chains(3, pm.model, kernel, n, num_warmup=w,
                          num_chains=4, device=cuda_device, init_jitter=0.1)

    got, want, counted, eager = _captured_and_eager(run, lambda: run(1, 0))
    assert _same(got, want)
    assert counted == eager and sum(counted.values()) > 0


@pytest.mark.cuda
def test_cuda_graph_chain_fn_matches_eager(cuda_device):
    """Table 1's chain (make_chain_fn), typed and hand-written, on logreg."""
    from repro_torch.infer.hmc import make_chain_fn
    from repro_torch.models import paper_suite

    pm = paper_suite.build("logreg", device=cuda_device)
    tvi = pm.model.typed_varinfo(
        torch.Generator(device=cuda_device).manual_seed(42)).link()
    for ld in (pm.model.make_logdensity_fn(tvi), pm.handwritten):
        chain = make_chain_fn(ld, 8, pm.step_size, pm.n_leapfrog)
        got, want, counted, eager = _captured_and_eager(lambda: chain(
            torch.Generator(device=cuda_device).manual_seed(0), tvi.flat()))
        assert _same(got, want) and counted == eager
        assert chain.programs.step.captures == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gaussian_10k", "logreg"])
def test_cuda_graph_nuts_matches_eager(cuda_device, name):
    """NUTS with its leaf iterations, doubling starts and merges captured
    (gaussian_10k's leaves one fused_potential_vg, logreg's autodiff)."""
    from repro_torch.infer import NUTS, run_chains
    from repro_torch.models import paper_suite

    pm = paper_suite.build(name, device=cuda_device)
    kernel = NUTS(step_size=pm.step_size, max_depth=6)
    def run(n=5, w=4):
        return run_chains(1, pm.model, kernel, n, num_warmup=w,
                          num_chains=4, device=cuda_device)

    got, want, counted, eager = _captured_and_eager(run, lambda: run(1, 0))
    assert _same(got, want) and counted == eager


def _gauss(dev, n=128, seed=0):
    import numpy as np
    from repro_torch import model, observe, sample
    from repro_torch.dists import HalfNormal, Normal

    y = np.random.default_rng(seed).normal(2.0, 1.0, size=n)

    @model
    def gauss(y):
        mu = sample("mu", Normal(0.0, 10.0))
        s = sample("s", HalfNormal(2.0))
        observe("y", Normal(mu, s), y)

    @model
    def gm(y):
        mu = sample("params", Normal(0.0, 10.0))
        observe("y", Normal(mu, 1.0), y)

    yt = torch.tensor(y, dtype=torch.float32, device=dev)
    return gauss(yt), gm(yt)


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["advi", "advi_minibatch", "map",
                                     "sgld"])
def test_cuda_graph_sampler_steps_match_eager(cuda_device, sampler):
    """ADVI's step (its draws, and with minibatch= the head of a randperm,
    inside the graph), MAP's Adam step and the subsampled SGLD step."""
    from repro_torch.infer import (ADVI, MAP, SGLD,
                                   make_subsampled_sgld_step)
    from repro_torch.sharding import Minibatch

    m, gm = _gauss(cuda_device)

    def run():
        if sampler.startswith("advi"):
            res = ADVI(num_mc=4, num_steps=20, minibatch=Minibatch(
                ("y",), 32) if sampler == "advi_minibatch" else None).run(
                2, m, device=cuda_device)
            return res.mu, res.log_sigma, res.elbo_trace
        if sampler == "map":
            est, losses = MAP(num_steps=20).run(1, m, device=cuda_device)
            return est["mu"], est["s"], losses
        sgld = SGLD(step_size=2e-2)
        step = make_subsampled_sgld_step(gm, Minibatch(("y",), 16), sgld)
        params = torch.zeros((), device=cuda_device)
        state = sgld.init(params)
        gen = torch.Generator(device=cuda_device).manual_seed(0)
        out = []
        for _ in range(20):
            params, state, lp = step(gen, params, state)
            out.append(lp)
        return params, torch.stack(out)

    got, want, counted, eager = _captured_and_eager(run)
    assert _same(got, want) and counted == eager


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.0, 1.0], ids=["greedy",
                                                          "sampled"])
def test_cuda_graph_serve_batch_matches_eager(cuda_device, temperature):
    """serve_batch's decode step replayed: the same tokens as eagerly, on
    both attention routes of a smoke config, greedy and sampled."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch.serve import serve_batch

    for impl in ("flash", "xla"):
        cfg = dataclasses.replace(configs.get_smoke_config("smollm-360m"),
                                  attn_impl=impl)
        got, want, counted, eager = _captured_and_eager(
            lambda: serve_batch("smollm-360m", cfg=cfg, max_new=10,
                                temperature=temperature,
                                device=cuda_device)[0])
        assert torch.equal(got, want) and counted == eager


@pytest.mark.cuda
def test_cuda_graph_capture_of_a_host_sync_raises_naming_the_program(
        cuda_device):
    """No silent fallback: a body that reads a value on the host raises
    at its capture (its second call), naming the program; a capture after
    it works."""
    from repro_torch.core.program import (CaptureError, CompiledProgram,
                                          ProgramKey)

    def body(x):
        return x * float(x.sum().item())

    prog = CompiledProgram(ProgramKey(("t",), "synced_step", None, (), ""),
                           body)
    x = torch.ones(4, device=cuda_device)
    prog(x)
    with pytest.raises(CaptureError, match="program 'synced_step'"):
        prog(x)
    torch.cuda.synchronize()
    fine = CompiledProgram(ProgramKey(("t",), "fine", None, (), ""),
                           lambda x: x * 2)
    for _ in range(3):
        out = fine(x)
    assert fine.captures == 1 and torch.equal(out, 2 * x)


@pytest.mark.cuda
def test_cuda_graph_scratch_growth_keeps_earlier_graphs(cuda_device,
                                                         monkeypatch):
    """Two programs captured with multi-block rows (the last-block
    scratch), then a third whose rows need more scratch than any call
    before: the capture stream's scratch grows by adding, and the first
    program replayed again still gives the eager kernel's bits. A capture
    stream of its own and the default sizes, whatever ran before."""
    from repro_torch.core import program as program_mod
    from repro_torch.core.program import CompiledProgram, ProgramKey
    from repro_torch.kernels import _scratch

    monkeypatch.setattr(program_mod, "_CAPTURE_STREAMS", {})
    monkeypatch.setitem(_scratch.HIGH, "partials", 4096)
    monkeypatch.setitem(_scratch.HIGH, "counts", 1024)

    def program(rows, n):
        def body(gen):
            z = torch.randn((rows, n), generator=gen, device=cuda_device)
            return ops.std_normal_sum_rows(z)
        return CompiledProgram(ProgramKey(("t",), f"rows{rows}", None, (),
                                          ""), body)

    def draws(prog, seed):
        gen = torch.Generator(device=cuda_device).manual_seed(seed)
        return [prog(gen) for _ in range(3)]

    def eager(rows, n, seed):
        gen = torch.Generator(device=cuda_device).manual_seed(seed)
        return [ops.std_normal_sum_rows(torch.randn(
            (rows, n), generator=gen, device=cuda_device)) for _ in range(3)]

    first, second = program(4, 40000), program(8, 40000)
    draws(first, 0)
    draws(second, 0)
    retired = len(_scratch.RETIRED)
    rows = _scratch.HIGH["partials"] // 20 + 64  # 20 blocks a row at 40,000
    third = program(rows, 40000)
    draws(third, 0)
    assert third.captures == 1 and len(_scratch.RETIRED) > retired
    got = draws(first, 9)
    assert first.captures == 1
    assert all(torch.equal(a, b) for a, b in zip(got, eager(4, 40000, 9)))


@pytest.mark.cuda
def test_cuda_graph_switch_toggle_takes_the_other_route(cuda_device):
    """gauss_unknown on the per-site evaluator: with the per-array switch
    off, no normal_sum launch; toggled on between two run_chains calls, the
    transitions (a new signature, a new graph) launch it."""
    from repro_torch.infer import HMC, run_chains
    from repro_torch.kernels import use_fused_logpdf
    from repro_torch.models import paper_suite

    pm = paper_suite.build("gauss_unknown", device=cuda_device)
    kernel = HMC(step_size=pm.step_size, n_leapfrog=pm.n_leapfrog)

    def run():
        ops.reset_launch_counts()
        run_chains(0, pm.model, kernel, 6, num_chains=4, device=cuda_device,
                   init_jitter=0.05, backend="reference")
        torch.cuda.synchronize()
        return dict(ops.LAUNCHES)

    assert run()["normal_sum"] == 0
    with use_fused_logpdf():
        on = run()
    assert on["normal_sum"] > 0
    assert run()["normal_sum"] == 0
