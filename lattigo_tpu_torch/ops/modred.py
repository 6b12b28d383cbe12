"""Vectorized Montgomery / Barrett / conditional modular reduction on
int64-carried uint64 tensors (see :mod:`lattigo_tpu_torch.ops.u64`).

Counterpart of ``lattigo_tpu/ops/modred.py``; names and semantics follow the
reference library (ring/modular_reduction.go):

* ``mform(a)``    = a * 2^64 mod q
* ``mred(x, y)``  = x * y * 2^-64 mod q
* ``bred_add(x)`` = x mod q for any 64-bit x
* ``bred(x, y)``  = x * y mod q
* ``cred(a)``     = a mod q for a < 2q

``*_constant`` variants return values in [0, 2q).  Per-modulus constants are
broadcastable tensors (typically [L, 1] against [..., L, N] coefficients).
All arithmetic wraps mod 2^64 exactly like Go's uint64.
"""

from __future__ import annotations

import torch

from lattigo_tpu_torch.ops.u64 import add_carry, ge, mul64_128, mulhi64

T = torch.Tensor


def cred(a: T, q: T) -> T:
    """a mod q for a in [0, 2q)."""
    return torch.where(ge(a, q), a - q, a)


def mform_constant(a: T, q: T, u0: T, u1: T) -> T:
    """a * 2^64 mod q in [0, 2q); (u0, u1) = floor(2^128/q) hi/lo words."""
    return -(a * u0 + mulhi64(a, u1)) * q


def mform(a: T, q: T, u0: T, u1: T) -> T:
    return cred(mform_constant(a, q, u0, u1), q)


def inv_mform_constant(a: T, q: T, qinv: T) -> T:
    """a * 2^-64 mod q in [0, 2q) for a in Montgomery form."""
    return q - mulhi64(a * qinv, q)


def inv_mform(a: T, q: T, qinv: T) -> T:
    return cred(inv_mform_constant(a, q, qinv), q)


def mred_constant(x: T, y: T, q: T, qinv: T) -> T:
    """x * y * 2^-64 mod q in [0, 2q); qinv = q^-1 mod 2^64."""
    alo, ahi = mul64_128(x, y)
    return ahi - mulhi64(alo * qinv, q) + q


def mred(x: T, y: T, q: T, qinv: T) -> T:
    return cred(mred_constant(x, y, q, qinv), q)


def bred_add_constant(x: T, q: T, u0: T) -> T:
    """x mod q in [0, 2q) for any 64-bit x; u0 = floor(2^128/q) >> 64."""
    return x - mulhi64(x, u0) * q


def bred_add(x: T, q: T, u0: T) -> T:
    return cred(bred_add_constant(x, q, u0), q)


def bred_constant(x: T, y: T, q: T, u0: T, u1: T) -> T:
    """x * y mod q in [0, 2q) for arbitrary 64-bit x, y."""
    alo, ahi = mul64_128(x, y)
    lhi = mulhi64(alo, u1)
    mlo, mhi = mul64_128(alo, u0)
    s0, carry = add_carry(mlo, lhi)
    s1 = mhi + carry
    mlo2, mhi2 = mul64_128(ahi, u1)
    _, carry2 = add_carry(mlo2, s0)
    lhi2 = mhi2 + carry2
    return alo - (ahi * u0 + s1 + lhi2) * q


def bred(x: T, y: T, q: T, u0: T, u1: T) -> T:
    return cred(bred_constant(x, y, q, u0, u1), q)


def mul_shoup(v: T, w: T, w_shoup: T, q: T) -> T:
    """v * w mod q in [0, 2q) for a precomputed w < q with
    w_shoup = floor(w * 2^64 / q); valid for any 64-bit v."""
    return v * w - mulhi64(v, w_shoup) * q
