#!/usr/bin/env python3
"""Which kernel torch.profiler loses in a cold process, and a second clock
that cannot lose one: the kernel nodes of a CUDA graph of the same calls.

    python3 probes/profiler_windows_cold.py [--build-dir DIR] [--windows N]
        [--after {nothing,profile,fork}] [--kernel {std_normal,potential}]

Builds the port's fused_logpdf library (``--kernel potential``: the
fused_leapfrog one) into ``--build-dir`` (a directory
that does not hold it yet makes this process build it with nvcc, as a
cold test process does). With ``--after profile`` it first opens one
profiler window (CUPTI starts), so that the build's ``nvcc`` processes
are forked after it, as in a cold test file whose later kernels are
built after its first profiler tests; with ``--after fork`` it also runs
``true`` in a subprocess after that window and before loading the
library. Then it opens N profiler windows (default 60) the
way ``tests/test_torch_kernels_cuda.py``'s ``_kernel_windows`` does (a
marker spin kernel, a synchronize, 0.02 s of host time, 10 calls, a
synchronize, 0.02 s), alternating the port's ``std_normal_sum`` at 4 x
400 (or ``fused_potential_vg`` at 4 x 10,000 on a mixed opcode table)
and torch's own ``mul_`` on the same data. For each window it reads
the kernels the profiler kept and the runtime calls that launched them;
for a window short of a kernel, each kept kernel's device start and each
launch's host start against the window's first call and last
synchronize, so that the lost one can be placed. Then it counts the
kernel nodes of one CUDA graph of the same 10 calls, with their names
through the CUDA API (``cuGraphGetNodes``, ``cuGraphNodeGetType``,
``cuGraphKernelNodeGetParams``, ``cuFuncGetName``). The card's name and
power limit come first; the last line is one JSON object.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PAD_S = 0.02


def graph_kernel_names(torch, fn, calls):
    """Names of the kernel nodes of one CUDA graph of ``calls`` calls of
    ``fn`` (other node types as ``<type N>``), in node order."""
    from repro_torch.core.program import _recording

    cuda = ctypes.CDLL("libcuda.so.1")
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with _recording(g, torch.device("cuda", torch.cuda.current_device())):
        for _ in range(calls):
            fn()
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cuda.cuGraphGetNodes(graph, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cuda.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0

    class Params(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p)] + [
            (f, ctypes.c_uint) for f in ("gx", "gy", "gz", "bx", "by", "bz",
                                         "shmem")] + [
            ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
            ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]

    get_params = getattr(cuda, "cuGraphKernelNodeGetParams_v2",
                         cuda.cuGraphKernelNodeGetParams)
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                       ctypes.byref(kind)) == 0
        if kind.value != 0:
            names.append(f"<type {kind.value}>")
            continue
        p = Params()
        assert get_params(ctypes.c_void_p(node), ctypes.byref(p)) == 0
        name = ctypes.c_char_p()
        if p.func:
            err = cuda.cuFuncGetName(ctypes.byref(name),
                                     ctypes.c_void_p(p.func))
        else:
            err = cuda.cuKernelGetName(ctypes.byref(name),
                                       ctypes.c_void_p(p.kern))
        names.append(name.value.decode() if err == 0 and name.value
                     else f"<kernel, name error {err}>")
    return names


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--build-dir", default=None)
    ap.add_argument("--windows", type=int, default=60)
    ap.add_argument("--after", choices=("nothing", "profile", "fork"),
                    default="nothing")
    ap.add_argument("--kernel", choices=("std_normal", "potential"),
                    default="std_normal")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profiler_windows_cold: CUDA is not available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_leapfrog import ops as lf_ops
    from repro_torch.kernels.fused_leapfrog import ref as lf_ref
    from repro_torch.kernels.fused_logpdf import ops
    if args.kernel == "potential":
        ops = lf_ops
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip(), flush=True)
    if args.build_dir:
        _build.BUILD_DIR = Path(args.build_dir)
    cold = not _build.library_path(ops.kernel_source()).is_file()
    if args.after != "nothing":  # CUPTI up before the build's processes
        y = torch.ones(8, device="cuda")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            y.mul_(1.0)
            torch.cuda.synchronize()
        if args.after == "fork":
            subprocess.run(["true"], check=True)
    t0 = time.perf_counter()
    ops._lib()
    build_s = time.perf_counter() - t0
    if args.kernel == "potential":
        spec = lf_ref.random_spec(10000, None, seed=1, run=512)
        z = 0.5 * torch.randn(4, 10000, device="cuda")
        port = ("port fused_potential_vg",
                lambda: lf_ops.potential_value_and_grad(spec, z))
    else:
        z = torch.randn(4, 400, device="cuda")
        port = ("port std_normal_sum", lambda: ops.std_normal_sum_rows(z))
    fns = {port[0]: port[1], "torch mul_": lambda: z.mul_(1.0)}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    out = {k: {"windows": 0, "short": []} for k in fns}
    t_start = time.time()
    for w in range(args.windows):
        label = list(fns)[w % 2]
        fn = fns[label]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(PAD_S)
            t_first = time.perf_counter()
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            t_last = time.perf_counter()
            time.sleep(PAD_S)
        events = prof.events()
        kernels = sorted((e for e in events if e.device_type.name == "CUDA"
                          and "spin" not in e.name and "Memset" not in e.name),
                         key=lambda e: e.time_range.start)
        spins = [e for e in events if e.device_type.name == "CUDA"
                 and "spin" in e.name]
        launches = sorted((e for e in events if e.device_type.name == "CPU"
                           and "aunch" in e.name),
                          key=lambda e: e.time_range.start)
        rec = out[label]
        rec["windows"] += 1
        if len(kernels) != 10:
            base = launches[0].time_range.start if launches else 0.0
            rec["short"].append({
                "window": w, "seconds": round(time.time() - t_start, 1),
                "kernels": len(kernels), "spin_kept": len(spins),
                "launches": len(launches),
                "launch_names": sorted({e.name for e in launches}),
                "kernel_start_us": [round(e.time_range.start - base, 1)
                                    for e in kernels],
                "launch_start_us": [round(e.time_range.start - base, 1)
                                    for e in launches],
                "calls_span_us": round((t_last - t_first) * 1e6, 1)})
    for label, rec in out.items():
        print(f"{label}: {rec['windows']} windows, {len(rec['short'])} short",
              flush=True)
        for s in rec["short"][:5]:
            print(f"    {s}", flush=True)
    graph = {}
    for label, fn in fns.items():
        try:
            names = graph_kernel_names(torch, fn, 10)
            graph[label] = {"nodes": len(names), "names": sorted(set(names))}
        except Exception as e:  # noqa: BLE001 - the probe reports it
            graph[label] = {"error": f"{type(e).__name__}: {e}"}
        print(f"graph nodes {label}: {graph[label]}", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "cold": cold,
                      "after": args.after,
                      "build_s": build_s, "windows": out, "graph": graph}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
