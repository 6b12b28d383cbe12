"""Host-side number theory for parameter/twiddle precomputation.

Everything here runs in pure Python (arbitrary-precision ints) at context-build
time; results become device constants.  Semantics mirror the reference library
(`ring/utils.go`, `ring/modular_reduction.go`) exactly where bit-exactness
depends on it — in particular `primitive_root` reproduces the reference's
deterministic Pollard-rho factor search (ring/utils.go:179-287) so that the
chosen 2N-th roots of unity, and therefore every NTT twiddle table, match the
reference's golden test vectors bit for bit.
"""

from __future__ import annotations

import math

from lattigo_tpu_torch.ops._small_primes import SMALL_PRIMES

MASK64 = (1 << 64) - 1

_SMALL_PRIME_SET = frozenset(SMALL_PRIMES)

# Deterministic Miller-Rabin witnesses, proven complete for n < 2^64.
_MR_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Primality for 64-bit integers (deterministic; same answers as the
    reference's 50-round Miller-Rabin in ring/utils.go:75-129)."""
    if n < 2:
        return False
    if n in _SMALL_PRIME_SET:
        return True
    for p in SMALL_PRIMES:
        if n % p == 0:
            return False
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_WITNESSES:
        if a % n == 0:
            continue
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _brent_rho(n: int) -> int:
    """One nontrivial factor of composite n via Brent's cycle variant of
    Pollard rho (deterministic seed schedule, so results are reproducible)."""
    if n % 2 == 0:
        return 2
    for c in range(1, 50):
        y, m_batch, g, r, q = 2, 128, 1, 1, 1
        x = ys = y
        while g == 1:
            x = y
            for _ in range(r):
                y = (y * y + c) % n
            k = 0
            while k < r and g == 1:
                ys = y
                for _ in range(min(m_batch, r - k)):
                    y = (y * y + c) % n
                    q = q * abs(x - y) % n
                g = math.gcd(q, n)
                k += m_batch
            r *= 2
        if g == n:
            g = 1
            while g == 1:
                ys = (ys * ys + c) % n
                g = math.gcd(abs(x - ys), n)
        if g != n:
            return g
    raise RuntimeError(f"rho failed to factor {n}")


def get_factors(n: int) -> list[int]:
    """Prime factor set of n: trial division by the reference's fixed
    small-prime table (ring/utils.go:253-287) then Pollard-Brent rho.

    The reference's own rho walk (ring/utils.go:222-250) can emit composite
    entries in rare cases; here factors are always fully split to primes.
    For every NTT modulus the library ships or generates, the resulting
    *set* is identical — which is all `primitive_root` depends on — and the
    golden-vector NTT tests pin the outcome bit-exactly."""
    factors: list[int] = []
    m = n
    for p in SMALL_PRIMES:
        add = False
        while m % p == 0:
            m //= p
            add = True
        if add:
            factors.append(p)
    if m == 1:
        return factors
    stack = [m]
    extra: list[int] = []
    while stack:
        v = stack.pop()
        if is_prime(v):
            extra.append(v)
            continue
        f = _brent_rho(v)
        stack.append(f)
        stack.append(v // f)
    for f in sorted(set(extra)):
        factors.append(f)
    return factors


def primitive_root(q: int) -> int:
    """Smallest generator g >= 3 of (Z/qZ)* accepted by the reference's test
    (ring/utils.go:179-202).  Must match exactly: the 2N-th root psi derives
    from it."""
    factors = get_factors(q - 1)
    g = 2
    while True:
        g += 1
        ok = True
        for f in factors:
            if pow(g, (q - 1) // f, q) == 1:
                ok = False
                break
        if ok:
            return g


def generate_ntt_primes(log_q: int, log_n: int, levels: int) -> list[int]:
    """NTT-friendly primes == 1 mod 2N walking upward from 2^logQ + 1
    (ring/utils.go:131-173; the reference's downward branch is dead code and
    is omitted here on purpose)."""
    if log_q > 60:
        raise ValueError("logQ must be between 1 and 60")
    two_n = 2 << log_n
    primes: list[int] = []
    x = (1 << log_q) + 1
    while len(primes) < levels:
        if is_prime(x):
            primes.append(x)
        x += two_n
        if x > MASK64:
            raise RuntimeError("prime search overflowed 64 bits")
    return primes


# ---------------------------------------------------------------------------
# Reduction-parameter precomputation (ring/modular_reduction.go)
# ---------------------------------------------------------------------------


def bred_params(q: int) -> tuple[int, int]:
    """Barrett constant floor(2^128 / q) as (hi, lo) 64-bit words
    (ring/modular_reduction.go:97-107)."""
    big = (1 << 128) // q
    return (big >> 64) & MASK64, big & MASK64


def mred_params(q: int) -> int:
    """qInv = q^-1 mod 2^64 (ring/modular_reduction.go:53-63)."""
    return pow(q, -1, 1 << 64)


def mform(a: int, q: int) -> int:
    """a * 2^64 mod q (Montgomery form)."""
    return (a << 64) % q


def inv_mform(a: int, q: int) -> int:
    """a * 2^-64 mod q."""
    return a * pow(1 << 64, -1, q) % q


def mod_exp(x: int, e: int, p: int) -> int:
    return pow(x, e, p)


def bit_reverse(x: int, nbits: int) -> int:
    return int(format(x, f"0{nbits}b")[::-1], 2) if nbits > 0 else 0


def bit_reverse_array(v, nbits: int):
    """:func:`bit_reverse` of every entry of a numpy integer array."""
    out = v & 0
    for b in range(nbits):
        out |= ((v >> b) & 1) << (nbits - 1 - b)
    return out


def psi_tables(q: int, n: int) -> tuple[list[int], list[int], int, int, int]:
    """Bit-reversed tables of psi^j and psi^-j in Montgomery form, plus
    N^-1, psi, psi^-1 (Montgomery), matching ring/ring_context.go:160-209.

    nttPsi[bitrev(j)] = psi^j * 2^64 mod q  for j in [0, N).
    """
    g = primitive_root(q)
    power = (q - 1) // (2 * n)
    psi = pow(g, power, q)
    psi_inv = pow(psi, -1, q)
    logn = n.bit_length() - 1
    ntt_psi = [0] * n
    ntt_psi_inv = [0] * n
    cur = 1
    cur_inv = 1
    for j in range(n):
        r = bit_reverse(j, logn)
        ntt_psi[r] = mform(cur, q)
        ntt_psi_inv[r] = mform(cur_inv, q)
        cur = cur * psi % q
        cur_inv = cur_inv * psi_inv % q
    n_inv_mont = mform(pow(n, -1, q), q)
    return ntt_psi, ntt_psi_inv, n_inv_mont, mform(psi, q), mform(psi_inv, q)
