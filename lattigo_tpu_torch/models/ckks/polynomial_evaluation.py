"""Baby-step/giant-step (Paterson-Stockmeyer) polynomial evaluation
(ckks/polynomial_evaluation.go) and Chebyshev-basis evaluation with
interpolation (ckks/chebyshev_interpolation.go, chebyshev_evaluation.go).

The port's copy of ``lattigo_tpu/models/ckks/polynomial_evaluation.py``:
the interpolation is pure Python floats, the evaluation composes the
evaluator's methods, so both packages give the same ciphertexts and scales
bit for bit.

Recorder (``utils/profiling.py``): the counter ``ckks.poly.products``, one
a ciphertext product (``mul_relin`` of two ciphertexts), counted while the
evaluation runs in Python, so a captured program counts its capture's once
a replay; the Chebyshev evaluation's spans ``ckks.cheby.basis`` (the power
basis, the affine map included) and ``ckks.cheby.tree`` (the recursion).
Neither runs in a replay."""

from __future__ import annotations

import dataclasses
import math

from lattigo_tpu_torch.models.ckks.elements import Ciphertext
from lattigo_tpu_torch.utils import profiling


def _product(ev, op0, op1, rlk) -> Ciphertext:
    """``ev.mul_relin(op0, op1, rlk)``, counted as ``ckks.poly.products``."""
    profiling.count("ckks.poly.products")
    return ev.mul_relin(op0, op1, rlk)


def _convert_coeffs(coeffs) -> tuple[int, dict[int, complex]]:
    cmap = {i: complex(c) for i, c in enumerate(coeffs)}
    return len(cmap) - 1, cmap


def _compute_power_basis(n: int, C: dict[int, Ciphertext], ev, rlk):
    """C[n] = C[ceil(n/2)] * C[floor(n/2)] (ckks/polynomial_evaluation.go:79-95)."""
    if n not in C:
        a = (n + 1) // 2
        b = n // 2
        _compute_power_basis(a, C, ev, rlk)
        _compute_power_basis(b, C, ev, rlk)
        C[n] = ev.rescale(_product(ev, C[a], C[b], rlk))


def _split_coeffs(coeffs, degree, max_degree):
    r = {i: coeffs.get(i, 0) for i in range(degree)}
    q = {0: coeffs.get(degree, 0)}
    for i in range(degree + 1, max_degree + 1):
        q[i - degree] = coeffs.get(i, 0)
    return q, r


def _eval_from_power_basis(coeffs, C, ev, rlk):
    """ckks/polynomial_evaluation.go:148-167."""
    res = ev.new_zero_ciphertext(C[1].level, C[1].scale)
    c0 = coeffs.get(0, 0)
    if abs(c0.real) > 1e-15 or abs(c0.imag) > 1e-15:
        res = ev.add_const(res, c0)
    for key in sorted(coeffs):
        c = coeffs[key]
        if key != 0 and (abs(c.real) > 1e-15 or abs(c.imag) > 1e-15):
            res = ev.mult_by_const_and_add(C[key], c, res)
    return ev.rescale(res)


def _recurse(max_degree, L, M, coeffs, C, ev, rlk, split_fn):
    if max_degree <= (1 << L):
        return _eval_from_power_basis(coeffs, C, ev, rlk)
    while 1 << (M - 1) > max_degree:
        M -= 1
    cq, cr = split_fn(coeffs, 1 << (M - 1), max_degree)
    res = _recurse(max_degree - (1 << (M - 1)), L, M - 1, cq, C, ev, rlk, split_fn)
    tmp = _recurse((1 << (M - 1)) - 1, L, M - 1, cr, C, ev, rlk, split_fn)
    res = _product(ev, res, C[1 << (M - 1)], rlk)
    res = ev.add(res, tmp)
    return ev.rescale(res)


def _evaluate_poly(ev, ct, coeffs, rlk, L):
    degree, cmap = _convert_coeffs(coeffs)
    C = {1: ct.copy()}
    M = (degree - 1).bit_length()
    for i in range(2, (1 << L) + 1):
        _compute_power_basis(i, C, ev, rlk)
    for i in range(L + 1, M):
        _compute_power_basis(1 << i, C, ev, rlk)
    return _recurse(degree, L, M, cmap, C, ev, rlk, _split_coeffs)


def evaluate_poly_fast(ev, ct: Ciphertext, coeffs, rlk) -> Ciphertext:
    """ceil(log2 deg)+1 levels (ckks/polynomial_evaluation.go:10-30)."""
    degree = len(list(coeffs)) - 1
    return _evaluate_poly(ev, ct, coeffs, rlk, ((degree - 1).bit_length()) >> 1)


def evaluate_poly_eco(ev, ct: Ciphertext, coeffs, rlk) -> Ciphertext:
    """One less level, more multiplications (ckks/polynomial_evaluation.go:33-53)."""
    return _evaluate_poly(ev, ct, coeffs, rlk, 1)


# ---------------------------------------------------------------------------
# Chebyshev basis (ckks/chebyshev_interpolation.go + chebyshev_evaluation.go)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ChebyshevInterpolation:
    coeffs: dict[int, complex]
    degree: int
    a: complex
    b: complex


def approximate(function, a, b, degree: int) -> ChebyshevInterpolation:
    """Chebyshev-node interpolation of ``function`` over [a, b]
    (ckks/chebyshev_interpolation.go:17-95)."""
    a, b = complex(a), complex(b)
    n = degree + 1
    nodes = [
        0.5 * (a + b)
        + 0.5 * (b - a) * math.cos((k - 0.5) * math.pi / n)
        for k in range(1, n + 1)
    ]
    fi = [complex(function(x)) for x in nodes]
    coeffs = [0j] * n
    for i in range(n):
        uu = (2 * nodes[i] - a - b) / (b - a)
        t_prev, t = 1 + 0j, uu
        for j in range(n):
            coeffs[j] += fi[i] * t_prev
            t_prev, t = t, 2 * uu * t - t_prev
    coeffs[0] /= n
    for i in range(1, n):
        coeffs[i] *= 2.0 / n
    return ChebyshevInterpolation(
        {i: c for i, c in enumerate(coeffs)}, degree, a, b
    )


def _compute_power_basis_cheby(n, C, ev, rlk):
    """C_n = 2*C_a*C_b - C_|a-b| (ckks/chebyshev_evaluation.go:60-103)."""
    if n not in C:
        a = (n + 1) // 2
        b = n // 2
        c = abs(a - b)
        _compute_power_basis_cheby(a, C, ev, rlk)
        _compute_power_basis_cheby(b, C, ev, rlk)
        if c != 0:
            _compute_power_basis_cheby(c, C, ev, rlk)
        t = ev.rescale(_product(ev, C[a], C[b], rlk))
        t = ev.add(t, t)
        C[n] = ev.add_const(t, -1) if c == 0 else ev.sub(t, C[c])


def _split_coeffs_cheby(coeffs, degree, max_degree):
    """p = q*T_degree + r in the Chebyshev basis
    (ckks/chebyshev_evaluation.go:130-146)."""
    r = {i: coeffs.get(i, 0) for i in range(degree)}
    q = {0: coeffs.get(degree, 0)}
    for i in range(degree + 1, max_degree + 1):
        q[i - degree] = 2 * coeffs.get(i, 0)
        r[2 * degree - i] = r.get(2 * degree - i, 0) - coeffs.get(i, 0)
    return q, r


def _evaluate_cheby(ev, ct, cheby: ChebyshevInterpolation, rlk, L):
    M = (cheby.degree - 1).bit_length()
    with profiling.span("ckks.cheby.basis"):
        C = {1: ct.copy()}
        # affine map of the input into [-1, 1] (ckks/chebyshev_evaluation.go:16-18)
        C[1] = ev.mult_by_const(C[1], 2 / (cheby.b - cheby.a))
        C[1] = ev.add_const(C[1], (-cheby.a - cheby.b) / (cheby.b - cheby.a))
        C[1] = ev.rescale(C[1])
        for i in range(2, (1 << L) + 1):
            _compute_power_basis_cheby(i, C, ev, rlk)
        for i in range(L + 1, M):
            _compute_power_basis_cheby(1 << i, C, ev, rlk)
    with profiling.span("ckks.cheby.tree"):
        return _recurse(cheby.degree, L, M, cheby.coeffs, C, ev, rlk, _split_coeffs_cheby)


def evaluate_cheby_fast(ev, ct, cheby: ChebyshevInterpolation, rlk) -> Ciphertext:
    """ceil(log deg)+2 levels (ckks/chebyshev_evaluation.go:9-33)."""
    return _evaluate_cheby(ev, ct, cheby, rlk, ((cheby.degree - 1).bit_length()) >> 1)


def evaluate_cheby_eco(ev, ct, cheby: ChebyshevInterpolation, rlk) -> Ciphertext:
    """One less level (ckks/chebyshev_evaluation.go:36-59)."""
    return _evaluate_cheby(ev, ct, cheby, rlk, 1)
