"""Default ring-layer test moduli (ring/params.go:11-69): NTT-prime chains
per logN used by the reference's ring-level tests and benchmarks."""

from __future__ import annotations

import functools

from lattigo_tpu_torch.ops import number_theory as nt


@functools.lru_cache(maxsize=None)
def default_qi(log_n: int, count: int = 2, log_q: int = 60) -> tuple[int, ...]:
    """`count` NTT primes of `log_q` bits for degree 2^log_n, walking upward
    exactly like the reference's generator (ring/utils.go:131-173)."""
    return tuple(nt.generate_ntt_primes(log_q, log_n, count))


@functools.lru_cache(maxsize=None)
def default_pi(log_n: int, count: int = 1, log_p: int = 60) -> tuple[int, ...]:
    """Key-switch special primes, drawn after the Qi from the same walk."""
    primes = nt.generate_ntt_primes(log_p, log_n, count + 8)
    return tuple(primes[8 : 8 + count])
