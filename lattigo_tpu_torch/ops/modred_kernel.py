"""The elementwise modular pass: the ring's Montgomery / Barrett /
conditional reductions as one CUDA launch each (``csrc/modred.cu``).

No TPU kernel: under ``jax.jit`` XLA fuses each chain of
``lattigo_tpu/ops/modred.py`` (``mred`` ``:71``) with the adds around it into
one device pass, and this kernel is that pass.  Its plain version is the
unchanged :mod:`lattigo_tpu_torch.ops.modred` (the fused forms below are
compositions of its functions), which a CPU tensor takes.

Every wrapper broadcasts its operands like the plain version and returns a
new contiguous tensor of the broadcast shape.  :func:`launch_plan` maps the
operands onto one ``[B, L, N]`` view of that shape (:func:`view_strides`,
which ``basis_ext.mod_up`` and ``key_switch.d_plan`` use too): each operand
becomes a tensor and its ``(B, L, N)`` strides (0 where it broadcasts);
where an operand's leading dims cannot collapse into one stride the plan
takes one ``.contiguous()`` copy of it (counted, ``_build.copy_counts``).

Bound on the GPU: the bytes (each operand read once, the output written
once).  Which calls launch, and the launch itself, are ``_build``'s
(``_build.FORCE_PLAIN`` sends CUDA tensors to the plain version).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from lattigo_tpu_torch import _build
from lattigo_tpu_torch.ops import modred
from lattigo_tpu_torch.utils import profiling

T = torch.Tensor

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


def view_strides(t: T, full: tuple[int, ...]) -> tuple[int, int, int] | None:
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
        st = view_strides(t, full)
        if st is None:
            t = t.expand(full).contiguous()
            copies += 1
            st = view_strides(t, full)
        ops.append(Operand(t, st))
    return Plan(shape, (math.prod(full[:-2]), full[-2], full[-1]), tuple(ops), copies)


def modarith(name: str, *operands: T) -> T:
    """Op ``name`` of :data:`OPS` on ``operands``, in its slots' order: one
    launch of ``csrc/modred.cu`` for CUDA tensors, the plain version for CPU
    tensors."""
    code, slots, plain = OPS[name]
    if not _build.takes_kernel("modred", *operands):
        return plain(*operands)
    return _modarith_kernel(name, code, slots, operands)


@profiling.timed("kernel.modred")
def _modarith_kernel(name: str, code: int, slots, operands) -> T:
    """:func:`modarith`'s launch (its host side is the span ``kernel.modred``)."""
    plan = launch_plan(operands)
    out = torch.empty(plan.shape, dtype=torch.int64, device=operands[0].device)
    if out.numel() == 0:
        return out
    desc = np.zeros((len(SLOTS), 4), dtype=np.int64)
    for slot, op in zip(slots, plan.operands):
        desc[SLOTS.index(slot)] = (op.tensor.data_ptr(), *op.strides)
    _build.launch("modred", out.device, (code, desc.ctypes.data, out.data_ptr(), *plan.dims),
                  lambda: f"{name} over {plan.dims}", copies=plan.copies,
                  record=(name, operands,
                          tuple(t for s, t in zip(slots, operands) if s in SLOTS[3:])))
    return out


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
