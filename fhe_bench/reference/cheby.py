"""Plain Chebyshev evaluation for the reference: Lattigo v1.3.1's
``Approximate`` (ckks/chebyshev_interpolation.go:17-95) and
``EvaluateChebyFast`` (ckks/chebyshev_evaluation.go:9-146, with
ckks/polynomial_evaluation.go's recursion and evaluation from the power
basis) on what each ciphertext encrypts, in float64.

A ciphertext of the circuit is modelled by its noiseless content
(:class:`Ct`): the slots times the scale (``m``, complex128), the scale (a
float, formed by the same float operations as Lattigo's) and the level.  Each
evaluator operation the circuit calls is written out with Lattigo's scale
rules (ckks/evaluator.go): ``Add`` / ``Sub`` multiply the operand of lower
scale by the integer ratio of the scales and keep the larger scale;
``AddConst`` adds round(c scale); ``MultByConst`` multiplies by round(c
2^logScale) for a non-integer c and raises the scale by that factor;
``MultByConstAndAdd`` first brings the accumulator to the constant's scale
by an integer ratio, or encodes the constant at the ratio of the scales;
``Rescale`` divides by the last modulus while the scale stays at or above
the default scale times that modulus over 2.  The integer ratios truncate,
so a scale can move by up to a part in 10^5 with no change of content: the
model keeps those moves, and the answer it gives is what Lattigo's circuit
computes without noise.  What is left between that and a decryption is the
scheme's noise (encryption, relinearization, the rounding of each rescale).

The model also lists, in order, the ciphertext products and the rescales'
divisions by level, from which :func:`work` derives the NTT rows Lattigo's
algorithm needs for one evaluation.

Departures from Lattigo's code: real constants only (the interpolant of a
real function has real coefficients); the division of a rescale is exact
(Lattigo's rounds each coefficient: noise); the relinearization is left out
(it adds noise only); the interpolation runs on Python floats, not complex
numbers (the imaginary parts are zero, so the real parts are the same
numbers).

:func:`decrypt` reads a ciphertext's message through the first two limbs
(the plain ring's NTT, the Chinese remainder theorem on limbs 0 and 1), so
that a message above half the first modulus, which a circuit at a lower
scale leaves (at the scale 2^30 the result's scale is about 2^50, the
first modulus's size), still decodes.  Imports numpy, torch and the plain
ring beside it: nothing of the program under test.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from fhe_bench.reference.ring import NTT, mulmod

NEGLIGIBLE = 1e-15  # a coefficient at or below it is skipped (polynomial_evaluation.go:148-167)


def approximate(function, a: float, b: float, degree: int) -> list[float]:
    """The coefficients of the Chebyshev interpolant of ``function`` on
    [a, b] at the degree + 1 Chebyshev nodes, in Lattigo's order of
    operations."""
    n = degree + 1
    nodes = [0.5 * (a + b) + 0.5 * (b - a) * math.cos((k - 0.5) * math.pi / n)
             for k in range(1, n + 1)]
    fi = [float(function(x)) for x in nodes]
    coeffs = [0.0] * n
    for i in range(n):
        u = (2 * nodes[i] - a - b) / (b - a)
        t_prev, t = 1.0, u
        for j in range(n):
            coeffs[j] += fi[i] * t_prev
            t_prev, t = t, 2 * u * t - t_prev
    coeffs[0] /= n
    for i in range(1, n):
        coeffs[i] *= 2.0 / n
    return coeffs


def interpolant(coeffs: list[float], a: float, b: float, x: np.ndarray) -> np.ndarray:
    """sum_j c_j T_j((2 x - a - b) / (b - a)) in float64 at real ``x``."""
    u = (2 * x - a - b) / (b - a)
    t_prev, t = np.ones_like(u), u
    out = coeffs[0] * t_prev
    for c in coeffs[1:]:
        out = out + c * t
        t_prev, t = t, 2 * u * t - t_prev
    return out


def scale_up(value: float, scale: float) -> int:
    """round(value scale), halves away from zero (ckks/utils.go scaleUpExact)."""
    x = float(scale) * float(value)
    c = int(abs(x) + 0.5)
    return -c if x < 0 else c


@dataclasses.dataclass
class Ct:
    """A ciphertext's noiseless content: slots times scale, scale, level."""

    m: np.ndarray
    scale: float
    level: int


class Model:
    """The evaluator operations EvaluateChebyFast calls, on :class:`Ct`, at
    the moduli ``qs`` and the default scale ``scale``; ``events`` lists the
    products and the rescale divisions as ``("product" | "rescale", level)``."""

    def __init__(self, qs: list[int], scale: float):
        self.qs, self.scale = qs, float(scale)
        self.events: list[tuple[str, int]] = []

    @staticmethod
    def _match(op0: Ct, op1: Ct) -> tuple[np.ndarray, np.ndarray, float]:
        m0, m1 = op0.m, op1.m
        s0, s1 = op0.scale, op1.scale
        if s0 > s1 and int(s0 / s1) != 0:
            m1 = m1 * int(s0 / s1)
        elif s1 > s0 and int(s1 / s0) != 0:
            m0 = m0 * int(s1 / s0)
        return m0, m1, max(s0, s1)

    def add(self, op0: Ct, op1: Ct) -> Ct:
        m0, m1, scale = self._match(op0, op1)
        return Ct(m0 + m1, scale, min(op0.level, op1.level))

    def sub(self, op0: Ct, op1: Ct) -> Ct:
        m0, m1, scale = self._match(op0, op1)
        return Ct(m0 - m1, scale, min(op0.level, op1.level))

    def add_const(self, ct: Ct, c: float) -> Ct:
        return Ct(ct.m + scale_up(c, ct.scale) if c else ct.m, ct.scale, ct.level)

    def _const_scale(self, c: float) -> float:
        return self.scale if c and c != int(c) else 1.0

    def mult_by_const(self, ct: Ct, c: float) -> Ct:
        scale = self._const_scale(c)
        return Ct(ct.m * scale_up(c, scale), ct.scale * scale, ct.level)

    def mult_by_const_and_add(self, ct: Ct, c: float, acc: Ct) -> Ct:
        scale = self._const_scale(c)
        m_acc, s_acc = acc.m, acc.scale
        if scale != 1.0:
            if s_acc < ct.scale * scale:
                ratio = int((scale * ct.scale) / s_acc)
                if ratio:
                    m_acc, s_acc = m_acc * ratio, scale * ct.scale
            elif s_acc > ct.scale * scale:
                scale = s_acc / ct.scale
        elif s_acc > ct.scale:
            scale = s_acc / ct.scale
        elif ct.scale > s_acc:
            ratio = int(ct.scale / s_acc)
            if ratio:
                m_acc, s_acc = m_acc * ratio, ct.scale
        return Ct(m_acc + ct.m * scale_up(c, scale), s_acc, min(ct.level, acc.level))

    def mul_relin(self, op0: Ct, op1: Ct) -> Ct:
        level = min(op0.level, op1.level)
        self.events.append(("product", level))
        return Ct(op0.m * op1.m, op0.scale * op1.scale, level)

    def rescale(self, ct: Ct) -> Ct:
        m, scale, level = ct.m, ct.scale, ct.level
        while level != 0 and scale >= (self.scale * self.qs[level]) / 2:
            self.events.append(("rescale", level))
            scale /= float(self.qs[level])
            m = m / self.qs[level]
            level -= 1
        return Ct(m, scale, level)


def _power_basis(n: int, C: dict, ev: Model) -> None:
    """T_n = 2 T_a T_b - T_|a-b| (chebyshev_evaluation.go:60-103)."""
    if n in C:
        return
    a, b = (n + 1) // 2, n // 2
    c = abs(a - b)
    _power_basis(a, C, ev)
    _power_basis(b, C, ev)
    if c:
        _power_basis(c, C, ev)
    t = ev.rescale(ev.mul_relin(C[a], C[b]))
    t = ev.add(t, t)
    C[n] = ev.add_const(t, -1) if c == 0 else ev.sub(t, C[c])


def _split(coeffs: dict, degree: int, max_degree: int) -> tuple[dict, dict]:
    """p = q T_degree + r in the Chebyshev basis (chebyshev_evaluation.go:130-146)."""
    r = {i: coeffs.get(i, 0) for i in range(degree)}
    q = {0: coeffs.get(degree, 0)}
    for i in range(degree + 1, max_degree + 1):
        q[i - degree] = 2 * coeffs.get(i, 0)
        r[2 * degree - i] = r.get(2 * degree - i, 0) - coeffs.get(i, 0)
    return q, r


def _from_basis(coeffs: dict, C: dict, ev: Model) -> Ct:
    """polynomial_evaluation.go:148-167."""
    one = C[1]
    res = Ct(np.zeros_like(one.m), one.scale, one.level)
    if abs(coeffs.get(0, 0)) > NEGLIGIBLE:
        res = ev.add_const(res, coeffs[0])
    for key in sorted(coeffs):
        if key and abs(coeffs[key]) > NEGLIGIBLE:
            res = ev.mult_by_const_and_add(C[key], coeffs[key], res)
    return ev.rescale(res)


def _recurse(max_degree: int, L: int, M: int, coeffs: dict, C: dict, ev: Model) -> Ct:
    if max_degree <= 1 << L:
        return _from_basis(coeffs, C, ev)
    while 1 << (M - 1) > max_degree:
        M -= 1
    cq, cr = _split(coeffs, 1 << (M - 1), max_degree)
    res = _recurse(max_degree - (1 << (M - 1)), L, M - 1, cq, C, ev)
    tmp = _recurse((1 << (M - 1)) - 1, L, M - 1, cr, C, ev)
    res = ev.mul_relin(res, C[1 << (M - 1)])
    return ev.rescale(ev.add(res, tmp))


def evaluate_cheby_fast(ev: Model, ct: Ct, coeffs: list[float], a: float, b: float) -> Ct:
    """EvaluateChebyFast: the affine map to [-1, 1], the power basis up to
    T_(2^L) and T_(2^i) for L < i < M, then the recursion
    (chebyshev_evaluation.go:9-33, 105-128)."""
    degree = len(coeffs) - 1
    L = (degree - 1).bit_length() >> 1
    M = (degree - 1).bit_length()
    one = ev.mult_by_const(ct, 2 / (b - a))
    one = ev.add_const(one, (-a - b) / (b - a))
    C = {1: ev.rescale(one)}
    for i in range(2, (1 << L) + 1):
        _power_basis(i, C, ev)
    for i in range(L + 1, M):
        _power_basis(1 << i, C, ev)
    return _recurse(degree, L, M, dict(enumerate(coeffs)), C, ev)


def work(qs: list[int], n_p: int, n: int, events: list[tuple[str, int]]) -> list[dict]:
    """The NTT transforms Lattigo's algorithm needs for ``events``
    (:attr:`Model.events`) at Q = ``qs``, ``n_p`` moduli of P and degree
    ``n``: a product at level l relinearizes (MulRelin, switchKeysInPlace:
    c2 to coefficients, each of the beta = ceil((l + 1) / n_p) digits
    extended to the Q limbs outside it and to P, ModDownSplitedNTTPQ of both
    key products); a rescale from level l (DivRoundByLastModulusNTT) takes
    the last limb of both polynomials to coefficients and brings it, reduced
    by each other modulus, back to the NTT domain.  Transforms of one shape
    and step are merged into one entry with a ``count``."""
    out: dict[tuple, dict] = {}

    def add(rows, limbs, inverse, step):
        key = (rows, limbs, inverse, step)
        if key in out:
            out[key]["count"] += 1
        else:
            out[key] = dict(rows=rows, limbs=limbs, n=n, inverse=inverse, count=1, step=step)

    for kind, lvl in events:
        nq = lvl + 1
        if kind == "product":
            beta = -(-nq // n_p)
            add(nq, nq, True, f"product at level {lvl}: c2 to coefficients")
            add(beta * nq - nq + beta * n_p, nq + n_p, False,
                f"product at level {lvl}: the {beta} digits extended to the Q limbs outside each "
                f"and the {n_p} P limbs")
            for _ in range(2):
                add(n_p, n_p, True, f"product at level {lvl}: ModDown, the P limbs to coefficients")
                add(nq, nq, False, f"product at level {lvl}: ModDown, the extension to Q back")
        else:
            add(2, 1, True, f"rescale from level {lvl}: the last limb to coefficients")
            add(2 * lvl, lvl, False, f"rescale from level {lvl}: the last limb reduced by each "
                                     "other modulus, to the NTT domain")
    return list(out.values())


def decrypt(qs: list[int], n: int, ct: torch.Tensor, secret: torch.Tensor) -> tuple[np.ndarray, int]:
    """Decrypts ``ct`` ([2, ..., L, N], NTT domain, L = len(qs) >= 2) with
    ``secret`` (integer coefficients [N]): the message's integer
    coefficients (float64 [..., N]), centred mod q_0 q_1, and the number of
    coefficients whose residues in the other limbs disagree with that
    integer (a message beyond q_0 q_1 / 2, or beyond 2^62, counts there)."""
    f = NTT(qs, n, ct.device)
    s_hat = f.forward(f.residues(secret.to(ct.device)))
    c0, c1 = ct[0] % f.q, ct[1] % f.q
    v = f.inverse((c0 + mulmod(c1, s_hat, f.q)) % f.q)
    q0, q1 = qs[0], qs[1]
    q1_t = torch.tensor([q1], dtype=torch.int64, device=ct.device)
    inv = torch.tensor([pow(q0, -1, q1)], dtype=torch.int64, device=ct.device)
    t = mulmod((v[..., 1, :] - v[..., 0, :]) % q1, inv, q1_t)
    t = torch.where(t > q1 // 2, t - q1, t)
    x = v[..., 0, :] + q0 * t  # exact while |x| < 2^63
    mismatch = int((x[..., None, :] % f.q != v).sum())
    return x.double().cpu().numpy(), mismatch
