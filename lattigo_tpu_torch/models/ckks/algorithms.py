"""Higher-level CKKS algorithms: powers and Goldschmidt inverse
(ckks/algorithms.go); counterpart of ``lattigo_tpu/models/ckks/algorithms.py``,
composed from the evaluator's methods."""

from __future__ import annotations

from lattigo_tpu_torch.models.ckks.elements import Ciphertext


def power_of_2(ev, ct: Ciphertext, log_pow2: int, rlk) -> Ciphertext:
    """ct^(2^logPow2), consuming logPow2 levels (ckks/algorithms.go:9-31)."""
    out = ct.copy()
    for _ in range(log_pow2):
        out = ev.rescale(ev.mul_relin(out, out, rlk))
    return out


def power(ev, ct: Ciphertext, degree: int, rlk) -> Ciphertext:
    """ct^degree by binary decomposition (ckks/algorithms.go:42-71)."""
    log_degree = degree.bit_length() - 1
    out = power_of_2(ev, ct, log_degree, rlk)
    degree -= 1 << log_degree
    while degree > 0:
        log_degree = degree.bit_length() - 1
        tmp = power_of_2(ev, ct, log_degree, rlk)
        out = ev.rescale(ev.mul_relin(out, tmp, rlk))
        degree -= 1 << log_degree
    return out


def inverse(ev, ct: Ciphertext, steps: int, rlk) -> Ciphertext:
    """Goldschmidt iteration for 1/ct; input range |1-ct| < 1
    (ckks/algorithms.go:76-100)."""
    cbar = ev.add_const(ev.neg(ct), 1)
    out = ev.add_const(cbar, 1)
    for _ in range(1, steps):
        cbar = ev.rescale(ev.mul_relin(cbar, cbar, rlk))
        tmp = ev.add_const(cbar, 1)
        out = ev.rescale(ev.mul_relin(tmp, out, rlk))
    return out
