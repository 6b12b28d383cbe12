"""The elementwise modular pass: the ring's Montgomery / Barrett /
conditional reductions as one CUDA launch each (``csrc/modred.cu``).

No TPU kernel: under ``jax.jit`` XLA fuses each chain of
``lattigo_tpu/ops/modred.py`` (``mred`` ``:71``) with the adds around it into
one device pass, and this kernel is that pass.  Its plain version is the
unchanged :mod:`lattigo_tpu_torch.ops.modred` (the fused forms below are
compositions of its functions), which a CPU tensor takes.

Every wrapper broadcasts its operands like the plain version and returns a
new contiguous tensor of the broadcast shape.  :func:`launch_plan` maps the
operands onto one ``[B, L, N]`` view of that shape: each operand becomes a
tensor and its ``(B, L, N)`` strides (0 where it broadcasts); where an
operand's leading dims cannot collapse into one stride the plan takes one
``.contiguous()`` copy of it (counted in ``copies``).

Bound on the GPU: the bytes (each operand read once, the output written
once).  A CUDA tensor launches the kernel or raises; ``FORCE_PLAIN`` (set
only by ``chip_smoke.py``, to trace the same path on the plain version)
sends it to the plain version.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from lattigo_tpu_torch import _build
from lattigo_tpu_torch.ops import modred
from lattigo_tpu_torch.utils import profiling

T = torch.Tensor

# Route CUDA tensors to the plain version instead of the kernels (this
# module's, basis_ext.mod_up's and key_switch.inner_product's):
# chip_smoke.py's before / after trace.
FORCE_PLAIN = False

SLOTS = ("x", "y", "z", "q", "qinv", "u0", "u1")  # csrc/modred.cu Slot


def _mred_add(x, y, z, q, qinv):
    return modred.cred(modred.mred(x, y, q, qinv) + z, q)


def _mred_sub(x, y, z, q, qinv):
    return modred.cred(q - modred.mred(x, y, q, qinv) + z, q)


# name -> (op code of csrc/modred.cu, the operand slots it takes in call
# order, the plain version)
OPS = {
    "cred": (0, ("x", "q"), modred.cred),
    "mred": (1, ("x", "y", "q", "qinv"), modred.mred),
    "mred_constant": (2, ("x", "y", "q", "qinv"), modred.mred_constant),
    "mform": (3, ("x", "q", "u0", "u1"), modred.mform),
    "inv_mform": (4, ("x", "q", "qinv"), modred.inv_mform),
    "bred_add": (5, ("x", "q", "u0"), modred.bred_add),
    "bred": (6, ("x", "y", "q", "u0", "u1"), modred.bred),
    "add": (7, ("x", "y", "q"), lambda x, y, q: modred.cred(x + y, q)),
    "sub": (8, ("x", "y", "q"), lambda x, y, q: modred.cred(x + q - y, q)),
    "neg": (9, ("x", "q"), lambda x, q: q - x),
    "mred_add": (10, ("x", "y", "z", "q", "qinv"), _mred_add),
    "mred_sub": (11, ("x", "y", "z", "q", "qinv"), _mred_sub),
    "mred_add_lazy": (12, ("x", "y", "z", "q", "qinv"),
                      lambda x, y, z, q, qinv: modred.mred(x, y, q, qinv) + z),
    "mred_diff": (13, ("x", "y", "z", "q", "qinv"),
                  lambda x, y, z, q, qinv: modred.mred(x + (q - y), z, q, qinv)),
    "add_bred": (14, ("x", "y", "q", "u0"), lambda x, y, q, u0: modred.bred_add(x + y, q, u0)),
}


class Operand(NamedTuple):
    """One operand of a launch: the tensor whose ``data_ptr`` the kernel
    reads (the caller's, or the plan's copy of it) and its strides over the
    ``[B, L, N]`` view."""

    tensor: T
    strides: tuple[int, int, int]


class Plan(NamedTuple):
    shape: tuple[int, ...]  # the output's shape: the operands broadcast
    dims: tuple[int, int, int]  # (B, L, N)
    operands: tuple[Operand, ...]
    copies: int  # operands copied because their leading dims do not collapse


def _strides(t: T, full: tuple[int, ...]) -> tuple[int, int, int] | None:
    """``t``'s strides over the ``[B, L, N]`` view of ``t`` broadcast to
    ``full``; None where its leading dims cannot collapse into one stride."""
    e = t.expand(full)
    st = e.stride()
    lead = [(s, st[i]) for i, s in enumerate(full[:-2]) if s != 1]
    for (_, outer), (size, inner) in zip(lead, lead[1:]):
        if outer != inner * size:
            return None
    sb = lead[-1][1] if lead else 0
    sl = st[-2] if full[-2] != 1 else 0
    sn = st[-1] if full[-1] != 1 else 0
    return sb, sl, sn


def launch_plan(operands) -> Plan:
    """The operands of one launch over the ``[B, L, N]`` view of their
    broadcast shape (at least two dims: ``[L, N]``)."""
    shape = tuple(torch.broadcast_shapes(*(t.shape for t in operands)))
    full = (1,) * max(0, 2 - len(shape)) + shape
    ops, copies = [], 0
    for t in operands:
        st = _strides(t, full)
        if st is None:
            t = t.expand(full).contiguous()
            copies += 1
            st = _strides(t, full)
        ops.append(Operand(t, st))
    return Plan(shape, (math.prod(full[:-2]), full[-2], full[-1]), tuple(ops), copies)


def takes_kernel(operands, what: str) -> bool:
    """Whether a call of ``what`` on ``operands`` launches its kernel: all
    on one CUDA device as int64 (unless ``FORCE_PLAIN``); all on the CPU
    takes the plain version; anything else raises."""
    devices = {t.device for t in operands}
    if devices == {torch.device("cpu")}:
        return False
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{what} takes tensors on one device, got {sorted(map(str, devices))}")
    if any(t.dtype != torch.int64 for t in operands):
        raise TypeError(f"{what} takes int64 tensors (uint64 bit patterns)")
    return not FORCE_PLAIN


def _takes_kernel(operands) -> bool:
    return takes_kernel(operands, "the modular pass")


_lib = None
# modred_launch: op, the [SLOTS, 4] operand table, out; B, L, N; the stream
ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [
    ctypes.c_void_p]


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("modred")
        lib.modred_launch.argtypes = ARGTYPES
        lib.modred_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _stream(device: torch.device) -> int:
    return torch._C._cuda_getCurrentRawStream(device.index)


def launch_on(device: torch.device, launch) -> int:
    """``launch(stream)`` with ``device`` current and its current stream:
    what a C entry returns."""
    if device.index == torch.cuda.current_device():
        return launch(_stream(device))
    with torch.cuda.device(device):
        return launch(_stream(device))


def _launch(code: int, slots: tuple[str, ...], plan: Plan, out: T) -> int:
    """Launches op ``code`` on the current stream of ``out``'s device;
    returns the C entry's error (0: launched)."""
    desc = np.zeros((len(SLOTS), 4), dtype=np.int64)
    for slot, op in zip(slots, plan.operands):
        desc[SLOTS.index(slot)] = (op.tensor.data_ptr(), *op.strides)
    return launch_on(out.device, lambda stream: _library().modred_launch(
        code, desc.ctypes.data, out.data_ptr(), *plan.dims, stream))


# the list that record() fills, while one is open
_RECORD: list | None = None


@contextlib.contextmanager
def record():
    """Yields a list that collects ``(name, layouts, constants)`` for every
    launch of the modular pass, of ``basis_ext.mod_up`` and of
    ``key_switch.inner_product`` in the block: ``layouts`` the operands'
    ``(shape, stride)``; ``constants`` this kernel's per-limb constant
    operands (q, qinv, u0, u1) themselves (no copy: a capture may be
    recording), ``mod_up``'s ``(params, dst_sel, centered)``, or the key
    switch's ``(ring, limbs, beta, beta_axis, index)``.  The
    calls a path gives the kernels."""
    global _RECORD
    prev, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = prev


def modarith(name: str, *operands: T) -> T:
    """Op ``name`` of :data:`OPS` on ``operands``, in its slots' order: one
    launch of ``csrc/modred.cu`` for CUDA tensors, the plain version for CPU
    tensors."""
    code, slots, plain = OPS[name]
    if not _takes_kernel(operands):
        return plain(*operands)
    return _modarith_kernel(name, code, slots, operands)


@profiling.timed("kernel.modred")
def _modarith_kernel(name: str, code: int, slots, operands) -> T:
    """:func:`modarith`'s launch (its host side is the span ``kernel.modred``)."""
    plan = launch_plan(operands)
    out = torch.empty(plan.shape, dtype=torch.int64, device=operands[0].device)
    if out.numel() == 0:
        return out
    err = _launch(code, slots, plan, out)
    if err == -2:
        raise RuntimeError(f"modred_launch does not take {name} over {plan.dims}")
    if err != 0:
        raise RuntimeError(f"modred_launch failed with CUDA error {err}")
    modarith.launches += 1
    modarith.copies += plan.copies
    if _RECORD is not None:
        _RECORD.append((name, tuple((tuple(t.shape), tuple(t.stride())) for t in operands),
                        tuple(t for s, t in zip(slots, operands) if s in SLOTS[3:])))
    return out


modarith.launches = 0  # launches of csrc/modred.cu, any op
modarith.copies = 0  # operand copies the launch plans made


def cred(a: T, q: T) -> T:
    return modarith("cred", a, q)


def mred(x: T, y: T, q: T, qinv: T) -> T:
    return modarith("mred", x, y, q, qinv)


def mred_constant(x: T, y: T, q: T, qinv: T) -> T:
    return modarith("mred_constant", x, y, q, qinv)


def mform(a: T, q: T, u0: T, u1: T) -> T:
    return modarith("mform", a, q, u0, u1)


def inv_mform(a: T, q: T, qinv: T) -> T:
    return modarith("inv_mform", a, q, qinv)


def bred_add(x: T, q: T, u0: T) -> T:
    return modarith("bred_add", x, q, u0)


def bred(x: T, y: T, q: T, u0: T, u1: T) -> T:
    return modarith("bred", x, y, q, u0, u1)


def add(a: T, b: T, q: T) -> T:
    """(a + b) mod q for a + b < 2q."""
    return modarith("add", a, b, q)


def sub(a: T, b: T, q: T) -> T:
    """(a - b) mod q for a + q - b < 2q."""
    return modarith("sub", a, b, q)


def neg(a: T, q: T) -> T:
    """q - a."""
    return modarith("neg", a, q)


def mred_add(x: T, y: T, z: T, q: T, qinv: T) -> T:
    """cred(mred(x, y) + z)."""
    return modarith("mred_add", x, y, z, q, qinv)


def mred_sub(x: T, y: T, z: T, q: T, qinv: T) -> T:
    """cred(q - mred(x, y) + z)."""
    return modarith("mred_sub", x, y, z, q, qinv)


def mred_add_lazy(x: T, y: T, z: T, q: T, qinv: T) -> T:
    """mred(x, y) + z, not reduced."""
    return modarith("mred_add_lazy", x, y, z, q, qinv)


def mred_diff(x: T, y: T, z: T, q: T, qinv: T) -> T:
    """mred(x + (q - y), z): ModDown's and the rescales' divide step."""
    return modarith("mred_diff", x, y, z, q, qinv)


def add_bred(x: T, y: T, q: T, u0: T) -> T:
    """bred_add(x + y)."""
    return modarith("add_bred", x, y, q, u0)
