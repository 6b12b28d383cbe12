"""The port's uint64 helpers and modular reductions against the JAX
package's, bit for bit, on the operand sets of test_modred.py (random 64-bit
words, including words >= 2^63).  Integers: tolerance 0."""

import random

import numpy as np
import pytest
import torch

from lattigo_tpu.ops import modred as jmr
from lattigo_tpu.ops import number_theory as nt
from lattigo_tpu.ops import u64 as ju
from lattigo_tpu_torch.ops import modred as tmr
from lattigo_tpu_torch.ops import u64 as tu

torch.set_num_threads(1)

Q60 = 1152921504606994433  # first NTT prime above 2^60 for N=2^13
Q30 = nt.generate_ntt_primes(30, 12, 1)[0]
MODULI = {"q60": Q60, "q30": Q30}

rng = random.Random(1234)
N = 2048
XS = np.array([rng.getrandbits(64) for _ in range(N)], dtype=np.uint64)
YS = np.array([rng.getrandbits(64) for _ in range(N)], dtype=np.uint64)
# edge words: 0, 1, 2^63 - 1, 2^63, 2^64 - 1 against each other
_E = np.array([0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1, 1 << 32, (1 << 32) - 1], dtype=np.uint64)
XS[: len(_E) ** 2] = np.repeat(_E, len(_E))
YS[: len(_E) ** 2] = np.tile(_E, len(_E))


def T(a):
    return tu.from_u64(a, "cpu")


def J(a):
    return ju.from_u64(a)


def _consts(q):
    b = nt.bred_params(q)
    vals = dict(q=q, u0=b[0], u1=b[1], qinv=nt.mred_params(q))
    jc = {k: ju.const64(v) for k, v in vals.items()}
    tc = {k: tu.from_u64(np.uint64(v), "cpu") for k, v in vals.items()}
    return jc, tc


def _eq(got: torch.Tensor, want):
    np.testing.assert_array_equal(tu.to_u64(got), ju.to_u64(want))


def test_roundtrip():
    np.testing.assert_array_equal(tu.to_u64(T(XS)), XS)
    assert T(XS).dtype == torch.int64
    big = [[0, 1], [(1 << 63) + 5, (1 << 64) - 1]]  # nested ints above 2^63
    np.testing.assert_array_equal(tu.to_u64(tu.from_u64(big, "cpu")), np.array(big, dtype=np.uint64))


def test_mul64_128_and_mulhi():
    lo, hi = tu.mul64_128(T(XS), T(YS))
    jlo, jhi = ju.mul64_128(J(XS), J(YS))
    _eq(lo, jlo)
    _eq(hi, jhi)
    _eq(tu.mulhi64(T(XS), T(YS)), jhi)
    ref = [int(a) * int(b) >> 64 for a, b in zip(XS.tolist(), YS.tolist())]
    np.testing.assert_array_equal(tu.to_u64(hi), np.array(ref, dtype=np.uint64))


def test_compare_shift_carry():
    X, Y = T(XS), T(YS)
    np.testing.assert_array_equal(tu.lt(X, Y).numpy(), XS < YS)
    np.testing.assert_array_equal(tu.ge(X, Y).numpy(), XS >= YS)
    np.testing.assert_array_equal(np.asarray(ju.lt64(J(XS), J(YS))), tu.lt(X, Y).numpy())
    for sh in (0, 1, 13, 32, 47, 63):
        _eq(tu.shr(X, sh), ju.shr64(J(XS), sh))
    s, c = tu.add_carry(X, Y)
    js, jc = ju.add64_carry(J(XS), J(YS))
    _eq(s, js)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc).astype(np.int64))
    _eq(X - Y, ju.sub64(J(XS), J(YS)))
    _eq(X * Y, ju.mullo64(J(XS), J(YS)))


# name -> (port call, JAX call) over operands a, b and the constant dicts
CASES = {
    "cred": lambda m, a, b, c: m.cred(a, c["q"]),
    "mform": lambda m, a, b, c: m.mform(a, c["q"], c["u0"], c["u1"]),
    "mform_constant": lambda m, a, b, c: m.mform_constant(a, c["q"], c["u0"], c["u1"]),
    "inv_mform": lambda m, a, b, c: m.inv_mform(a, c["q"], c["qinv"]),
    "inv_mform_constant": lambda m, a, b, c: m.inv_mform_constant(a, c["q"], c["qinv"]),
    "mred": lambda m, a, b, c: m.mred(a, b, c["q"], c["qinv"]),
    "mred_constant": lambda m, a, b, c: m.mred_constant(a, b, c["q"], c["qinv"]),
    "bred_add": lambda m, a, b, c: m.bred_add(a, c["q"], c["u0"]),
    "bred_add_constant": lambda m, a, b, c: m.bred_add_constant(a, c["q"], c["u0"]),
    "bred": lambda m, a, b, c: m.bred(a, b, c["q"], c["u0"], c["u1"]),
    "bred_constant": lambda m, a, b, c: m.bred_constant(a, b, c["q"], c["u0"], c["u1"]),
}


# cred is defined on [0, 2q) only, so it has no raw-64-bit case
_PARAMS = [
    (name, qname, operands)
    for name in CASES for qname in MODULI for operands in ("raw64", "reduced")
    if not (name == "cred" and operands == "raw64")
]


@pytest.mark.parametrize("name,qname,operands", _PARAMS)
def test_modred_matches_jax(name, qname, operands):
    q = MODULI[qname]
    jc, tc = _consts(q)
    if operands == "raw64":
        xs, ys = XS, YS
    else:
        xs, ys = XS % np.uint64(q), YS % np.uint64(q)
        if name == "cred":
            xs = xs + (YS & np.uint64(1)) * np.uint64(q)
    _eq(CASES[name](tmr, T(xs), T(ys), tc), CASES[name](jmr, J(xs), J(ys), jc))


@pytest.mark.parametrize("qname", list(MODULI))
def test_mul_shoup_matches_jax_and_ints(qname):
    q = MODULI[qname]
    jc, tc = _consts(q)
    w = YS % np.uint64(q)
    ws = np.array([(int(v) << 64) // q for v in w.tolist()], dtype=np.uint64)
    got = tmr.mul_shoup(T(XS), T(w), T(ws), tc["q"])
    _eq(got, jmr.mul_shoup(J(XS), J(w), J(ws), jc["q"]))
    lazy = tu.to_u64(got)
    assert (lazy < 2 * q).all()
    want = np.array([int(a) * int(b) % q for a, b in zip(XS.tolist(), w.tolist())], dtype=np.uint64)
    np.testing.assert_array_equal(lazy % np.uint64(q), want)


@pytest.mark.parametrize("qname", list(MODULI))
def test_exact_against_python_ints(qname):
    q = MODULI[qname]
    _, tc = _consts(q)
    xq = XS % np.uint64(q)
    want = np.array([(int(a) << 64) % q for a in xq.tolist()], dtype=np.uint64)
    xm = tmr.mform(T(xq), tc["q"], tc["u0"], tc["u1"])
    np.testing.assert_array_equal(tu.to_u64(xm), want)
    want = np.array([int(a) * int(b) % q for a, b in zip(XS.tolist(), YS.tolist())], dtype=np.uint64)
    np.testing.assert_array_equal(tu.to_u64(tmr.bred(T(XS), T(YS), tc["q"], tc["u0"], tc["u1"])), want)
    np.testing.assert_array_equal(tu.to_u64(tmr.bred_add(T(XS), tc["q"], tc["u0"])), XS % np.uint64(q))
