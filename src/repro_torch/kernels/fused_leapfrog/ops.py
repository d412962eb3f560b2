"""Public entry points for the fused leapfrog and the fused potential.

``fused_leapfrog(spec, q, p, grad, step_size, n_steps)`` runs the whole
n-step integrator as one unit and ``potential_value_and_grad(spec, u)``
one analytic evaluation. On a CUDA tensor each launches its hand-written
kernel in ``csrc/fused_leapfrog.cu`` (or raises); on a CPU tensor each
runs its plain version in ``ref.py``. Nothing falls back. Launches are
counted in ``LAUNCHES``.

Both take ``(dim,)`` or ``(num_chains, dim)`` states and return
``repro_torch.infer.hmc._leapfrog``'s ``(q, p, logp, grad)`` contract
(``(logp, grad)`` for the potential), so the HMC transition swaps
integrators without touching the MH correction. ``logp`` includes
``spec.const``, added in float32 after the sum. A
:class:`~repro_torch.kernels.fused_leapfrog.spec.CondPotentialSpec` goes
to ``ref.leapfrog_cond_ref`` and ``ref.cond_value_and_grad`` on every
device and launches nothing, as ``repro`` sends it to its jnp version:
its head term replays model code, which no generic kernel absorbs. The
state already carries the chain axis, so there is no ``vmap`` rule; and no
``torch.autograd.Function``, since MCMC transitions are never
differentiated through.

Each is one launch a call, of one kernel. ``leapfrog_parts`` (pure
Python) gives its blocks a chain from ``dim`` alone; the last-block
partials and counts are ``kernels._scratch``'s, kept once per (device,
stream), and a call allocates only its outputs: the final q, p and
gradient as views of one ``(3, chains, dim)`` tensor (the gradient alone
for the potential), and the potential.
"""
from __future__ import annotations

import contextlib
import ctypes
import weakref
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels._build import KernelError, load_library
from repro_torch.kernels._dispatch import plain_requested
from repro_torch.kernels._scratch import last_block_scratch
from repro_torch.kernels.fused_leapfrog import ref
from repro_torch.kernels.fused_leapfrog.spec import (CondPotentialSpec,
                                                     PotentialSpec)

__all__ = ["LAUNCHES", "reset_launch_counts", "fused_leapfrog",
           "potential_value_and_grad", "kernel_source", "LEAPFROG_SHARE",
           "leapfrog_parts"]

# kernel name -> launches since the last reset (one per wrapper call that
# reached the card; the CPU path does not count)
LAUNCHES = {"fused_leapfrog": 0, "fused_potential_vg": 0}

_ANY_OP = -1
# fused_leapfrog.cu kLfThreads: coordinates of one chain a block holds, one
# a thread, for both entry points
LEAPFROG_SHARE = 256
_SAME_DEVICE = contextlib.nullcontext()  # the input is on the current device
# spec -> {device index: (table addresses, uniform opcode or -1, const in
# float32)}, taken once per spec and device
_SPEC_ARGS = weakref.WeakKeyDictionary()

_LIB = None
_FNS = {}  # kernel name -> its bound C function, set by _lib()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_source() -> Path:
    return Path(__file__).resolve().parent / "csrc" / "fused_leapfrog.cu"


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = load_library(kernel_source())
        p, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_float)
        # q, p, g (pointer, row stride), eps (pointer, stride, value), the
        # table, inv_mass, uniform_op, rows, dim, n_steps, nparts,
        # state_out, partials, counts, const, out, stream
        lib.repro_fused_leapfrog.argtypes = (
            [p, i64, p, i64, p, i64, p, i64, f32] + [p] * 5
            + [p, i32, i32, i64, i32, i32, p, p, p, f32, p, p])
        lib.repro_fused_leapfrog.restype = i32
        # u (pointer, row stride), the table, uniform_op, rows, dim, nparts,
        # g_out, partials, counts, const, out, stream
        lib.repro_fused_potential_vg.argtypes = (
            [p, i64] + [p] * 5 + [i32, i32, i64, i32, p, p, p, f32, p, p])
        lib.repro_fused_potential_vg.restype = i32
        lib.repro_fused_leapfrog_error_string.argtypes = [i32]
        lib.repro_fused_leapfrog_error_string.restype = ctypes.c_char_p
        _FNS.update(fused_leapfrog=lib.repro_fused_leapfrog,
                    fused_potential_vg=lib.repro_fused_potential_vg)
        _LIB = lib
    return _LIB


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        msg = _lib().repro_fused_leapfrog_error_string(err).decode()
        raise KernelError(f"{kernel} launch failed: CUDA error {err} ({msg})")


def _device_kind(*ts: torch.Tensor) -> str:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {sorted(map(str, devs))}")
    kind = ts[0].device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no fused_leapfrog kernel for device '{kind}'")
    return kind


def _check_state(name: str, t: torch.Tensor, shape) -> None:
    """A state input: float32 of ``shape`` (the card also needs a unit
    inner stride, which :func:`_row_stride` checks)."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def _row_stride(name: str, t: torch.Tensor) -> int:
    rows, dim = t.shape
    if dim > 1 and t.stride(1) != 1:
        raise ValueError(f"{name}: inner stride must be 1, got {t.stride()}")
    return t.stride(0) if rows > 1 else dim


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t if t.dim() == 2 else t.unsqueeze(0)


def _check_spec(spec: PotentialSpec, q: torch.Tensor) -> None:
    if not isinstance(spec, (PotentialSpec, CondPotentialSpec)):
        raise TypeError(f"expected a PotentialSpec or CondPotentialSpec, "
                        f"got {type(spec).__name__}")
    if q.dim() not in (1, 2) or q.shape[-1] != spec.dim:
        raise ValueError(f"expected a state of shape ({spec.dim},) or "
                         f"(num_chains, {spec.dim}), got {tuple(q.shape)}")


def _eps_arg(step_size, rows: int, device):
    """The step size as the kernel reads it: ``(address, stride, value)``
    of a float32 0-d or ``(rows,)`` tensor on ``device`` (chain c's step at
    ``address + c * stride``), or ``(None, 0, value)`` for a number. Also
    returns the tensor, which must live until the launch."""
    if not torch.is_tensor(step_size):
        return None, 0, float(step_size), None
    if step_size.device != device:
        raise ValueError(f"step_size on {step_size.device}, state on "
                         f"{device}")
    eps = (step_size if step_size.dtype == torch.float32
           else step_size.to(torch.float32))
    if eps.dim() == 0:
        return eps.data_ptr(), 0, 0.0, eps
    if tuple(eps.shape) != (rows,):
        raise ValueError(f"step_size: expected a number or shape "
                         f"({rows},), got {tuple(eps.shape)}")
    return eps.data_ptr(), eps.stride(0), 0.0, eps


def leapfrog_parts(dim: int) -> int:
    """Blocks of one chain, ``ceil(dim / LEAPFROG_SHARE)``: 1 writes the
    chain's potential itself, more merge in the last block to finish. From
    ``dim`` alone, so a thread's coordinate and the order of the
    potential's sum never change between calls (reruns are bit-identical
    whatever the inputs' layout). Pure Python, as ``fused_leapfrog.cu``
    checks it."""
    return max(1, -(-dim // LEAPFROG_SHARE))


def _spec_args(spec: PotentialSpec, index: int):
    """The table as ``fused_leapfrog.cu`` takes it on device ``index``:
    (addresses of op, c0..c3; the uniform opcode or -1; the const in
    float32), once per spec and device."""
    per = _SPEC_ARGS.get(spec)
    if per is None:
        per = _SPEC_ARGS[spec] = {}
    args = per.get(index)
    if args is None:
        addrs = tuple(t.data_ptr() for t in
                      spec.coeff_arrays(torch.device("cuda", index)))
        args = per[index] = (
            addrs, _ANY_OP if spec.uniform_op is None else spec.uniform_op,
            ref._const(spec))
    return args


def _launch(kernel: str, index: int, rows: int, nparts: int, const: float,
            out: torch.Tensor, *args) -> None:
    """One launch of ``kernel`` on device ``index``: its C function takes
    ``args``, then the merge's partials and counts (the current stream's
    scratch, when a chain takes several blocks), the const, the ``rows``
    potentials ``out`` and the stream. Raises on a refused launch."""
    fn = _FNS.get(kernel)
    if fn is None:  # the first call builds and binds the library
        _lib()
        fn = _FNS[kernel]
    with (_SAME_DEVICE if index == torch.cuda.current_device()
          else torch.cuda.device(index)):
        # the stream's handle without building a Stream object
        stream = torch._C._cuda_getCurrentRawStream(index)
        partials = counts = None
        if nparts > 1:  # one float a (chain, block)
            partials, counts = last_block_scratch(index, stream, rows,
                                                  rows * nparts)
        err = fn(*args, partials, counts, const, out.data_ptr(), stream)
    if err:
        _raise_on(err, kernel)
    LAUNCHES[kernel] += 1


def fused_leapfrog(spec: PotentialSpec, q: torch.Tensor, p: torch.Tensor,
                   grad: torch.Tensor, step_size, n_steps: int, *,
                   inv_mass: Optional[torch.Tensor] = None,
                   use_pallas: Optional[bool] = None,
                   interpret: Optional[bool] = None, block_rows: int = 256):
    """n-step leapfrog on a separable potential; returns
    ``(q, p, logp, grad)``.

    Parameters
    ----------
    spec : PotentialSpec or CondPotentialSpec
        Compiled (conditionally) separable potential
        (``repro_torch.core.potential``); a conditional one runs
        ``ref.leapfrog_cond_ref`` on every device.
    q, p, grad : torch.Tensor, float32, ``(dim,)`` or ``(num_chains, dim)``
        Position, momentum and the potential gradient at ``q``.
    step_size : float, 0-d tensor or ``(num_chains,)`` tensor
        Leapfrog step size, per chain when a vector.
    n_steps : int
        Number of leapfrog steps.
    inv_mass : torch.Tensor, optional
        Diagonal inverse mass ``(dim,)`` (velocity = inv_mass * momentum);
        ``None`` = identity metric.
    use_pallas, interpret, block_rows
        The JAX package's switches: ``use_pallas=False`` or
        ``interpret=True`` runs the plain version (``kernels._dispatch``);
        ``block_rows`` is ignored.

    Returns
    -------
    (q, p, logp, grad)
        Final state; ``logp`` is the full potential (with ``spec.const``)
        at the final position, ``()`` or ``(num_chains,)``.
    """
    _check_spec(spec, q)
    for name, t in (("q", q), ("p", p), ("grad", grad)):
        _check_state(name, t, q.shape)
    if inv_mass is not None:
        _check_state("inv_mass", inv_mass, (spec.dim,))
    n_steps = int(n_steps)
    if n_steps < 0:
        raise ValueError(f"n_steps must be >= 0, got {n_steps}")
    if isinstance(spec, CondPotentialSpec):
        return ref.leapfrog_cond_ref(spec, q, p, grad, step_size, n_steps,
                                     inv_mass=inv_mass)
    extra = () if inv_mass is None else (inv_mass,)
    if (plain_requested(use_pallas, interpret)
            or _device_kind(q, p, grad, *extra) == "cpu"):
        return ref.leapfrog_ref(spec, q, p, grad, step_size, n_steps,
                                inv_mass=inv_mass)
    q2, p2, g2 = _rows(q), _rows(p), _rows(grad)
    rows, dim = q2.shape
    dev = q.device
    index = dev.index
    strides = (_row_stride("q", q2), _row_stride("p", p2),
               _row_stride("grad", g2))
    if inv_mass is not None and dim > 1 and inv_mass.stride(0) != 1:
        inv_mass = inv_mass.contiguous()
    eps_addr, eps_stride, eps_value, _eps = _eps_arg(step_size, rows, dev)
    table, uop, const = _spec_args(spec, index)
    state = torch.empty((3, rows, dim), dtype=torch.float32, device=dev)
    out = torch.empty(rows, dtype=torch.float32, device=dev)
    nparts = leapfrog_parts(dim)
    _launch("fused_leapfrog", index, rows, nparts, const, out,
            q2.data_ptr(), strides[0], p2.data_ptr(), strides[1],
            g2.data_ptr(), strides[2], eps_addr, eps_stride, eps_value,
            *table, None if inv_mass is None else inv_mass.data_ptr(), uop,
            rows, dim, n_steps, nparts, state.data_ptr())
    q_out, p_out, g_out = state.unbind(0)
    if q.dim() == 1:
        return q_out[0], p_out[0], out[0], g_out[0]
    return q_out, p_out, out, g_out


def potential_value_and_grad(spec: PotentialSpec, u: torch.Tensor, *,
                             use_pallas: Optional[bool] = None,
                             interpret: Optional[bool] = None,
                             block_rows: int = 256):
    """Fused analytic ``(logp, grad)`` of the compiled potential at ``u``
    (``(dim,)`` or ``(num_chains, dim)``, any row stride, 0 included); used
    for chain init. A ``CondPotentialSpec`` runs
    ``ref.cond_value_and_grad`` on every device. ``logp`` includes
    ``spec.const``. ``use_pallas=False`` or ``interpret=True`` runs the
    plain version; ``block_rows`` is ignored.

    On the card one launch a call, ``fused_leapfrog``'s kernel evaluating
    the gradient at ``u``: the same blocks a chain (``leapfrog_parts``),
    the same last-block merge and scratch; a call allocates only the
    gradient and the potential."""
    _check_spec(spec, u)
    _check_state("u", u, u.shape)
    if isinstance(spec, CondPotentialSpec):
        return ref.cond_value_and_grad(spec, u)
    if plain_requested(use_pallas, interpret) or _device_kind(u) == "cpu":
        if u.dim() == 1:
            return ref.potential_value_and_grad_ref(spec, u)
        # a chain at a time, as the kernel takes a row: the CPU's vector
        # loops round a row's last elements another way inside a longer
        # buffer, and a chain's numbers must not depend on its batch
        vg = [ref.potential_value_and_grad_ref(spec, r) for r in u.unbind(0)]
        return (torch.stack([v for v, _ in vg]),
                torch.stack([g for _, g in vg]))
    u2 = _rows(u)
    rows, dim = u2.shape
    dev = u.device
    index = dev.index
    stride = _row_stride("u", u2)
    table, uop, const = _spec_args(spec, index)
    g_out = torch.empty((rows, dim), dtype=torch.float32, device=dev)
    out = torch.empty(rows, dtype=torch.float32, device=dev)
    nparts = leapfrog_parts(dim)
    _launch("fused_potential_vg", index, rows, nparts, const, out,
            u2.data_ptr(), stride, *table, uop, rows, dim, nparts,
            g_out.data_ptr())
    if u.dim() == 1:
        return out[0], g_out[0]
    return out, g_out
