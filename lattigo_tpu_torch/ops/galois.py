"""Galois elements of the column rotations (ring/ring_galois.go).  Only the
parameter generation the scheme context needs is ported; the automorphism
permutes (``permute``, ``permute_ntt``) come with the rotations."""

from __future__ import annotations


def gen_galois_params(n: int, gen: int) -> list[int]:
    """Galois elements gen^i mod 2N for column rotations
    (ring/ring_galois.go:9-26)."""
    m = n << 1
    out = [1]
    for _ in range(1, n >> 1):
        out.append(out[-1] * gen % m)
    return out
