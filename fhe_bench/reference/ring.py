"""Plain arithmetic of R_q = Z_q[X]/(X^N + 1) for the reference.

* The moduli as Lattigo v1.3.1 generates them (ring/utils.go
  GenerateNTTPrimes: primes = 1 mod 2N walking up from 2^logQ + 1, one pool
  per bit size, handed out in the order the parameter set lists them).
* The 2N-th root psi Lattigo picks (ring/ring_context.go GenNTTParams:
  g^((q - 1) / 2N) for g the smallest generator >= 3 of (Z/qZ)*).
* A negacyclic NTT in Lattigo's order, written from its definition:
  slot k of the transform of a holds a(psi^(2 bitrev(k) + 1)).

Words are int64 tensors holding values in [0, q); every modulus is below
2^56, so a product is formed exactly by Horner's rule over 6-bit chunks of
one factor with no intermediate above 2^63.  Imports torch alone: nothing of
the program under test.
"""

from __future__ import annotations

import math

import torch

MAX_MODULUS_BITS = 56
_CHUNK = 6
_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)  # exact below 2^64


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 2^64."""
    if n < 2:
        return False
    for p in _WITNESSES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _WITNESSES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def gen_moduli(log_n: int, *groups) -> list[list[int]]:
    """Each group of bit sizes as primes = 1 mod 2N; primes of one bit size
    come from one pool walking up from 2^bits + 1, taken in group order."""
    step = 2 << log_n
    nxt: dict[int, int] = {}
    out = []
    for group in groups:
        primes = []
        for bits in group:
            x = nxt.get(bits, (1 << bits) + 1)
            while not is_prime(x):
                x += step
            primes.append(x)
            nxt[bits] = x + step
        out.append(primes)
    return out


def _factor(n: int) -> set[int]:
    """The prime factors of n (trial division, then Pollard's rho)."""
    out = set()
    for p in range(2, 1000):
        while n % p == 0:
            out.add(p)
            n //= p
    stack = [n] if n > 1 else []
    while stack:
        m = stack.pop()
        if is_prime(m):
            out.add(m)
            continue
        c = 1
        while True:
            x = y = 2
            d = 1
            while d == 1:
                x = (x * x + c) % m
                y = (y * y + c) % m
                y = (y * y + c) % m
                d = math.gcd(abs(x - y), m)
            if d != m:
                break
            c += 1
        stack += [d, m // d]
    return out


def psi(q: int, n: int) -> int:
    """Lattigo's primitive 2N-th root of unity mod q."""
    factors = _factor(q - 1)
    g = 3
    while any(pow(g, (q - 1) // f, q) == 1 for f in factors):
        g += 1
    return pow(g, (q - 1) // (2 * n), q)


def mulmod(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """a * b mod q, exactly, for words in [0, q) and q < 2^56 (broadcast)."""
    r = torch.zeros(torch.broadcast_shapes(a.shape, b.shape, q.shape), dtype=torch.int64,
                    device=a.device)
    for k in range(-(-MAX_MODULUS_BITS // _CHUNK) - 1, -1, -1):
        r = (r * (1 << _CHUNK) + a * ((b >> (_CHUNK * k)) & ((1 << _CHUNK) - 1))) % q
    return r


def _powers(root: torch.Tensor, n: int, q: torch.Tensor) -> torch.Tensor:
    """[L, n]: root^j mod q for j < n, by doubling."""
    out = torch.ones_like(root)
    step = root
    while out.shape[-1] < n:
        out = torch.cat([out, mulmod(out, step, q)], dim=-1)
        step = mulmod(step, step, q)
    return out


def _bitrev(n: int, device) -> torch.Tensor:
    bits = n.bit_length() - 1
    j = torch.arange(n, device=device)
    out = torch.zeros_like(j)
    for b in range(bits):
        out |= ((j >> b) & 1) << (bits - 1 - b)
    return out


class NTT:
    """The negacyclic transform of R_q for each modulus of ``moduli``
    (limbs on the second-to-last axis), in Lattigo's slot order."""

    def __init__(self, moduli, n: int, device=None):
        if max(moduli) >> MAX_MODULUS_BITS:
            raise ValueError(f"a modulus of {max(moduli).bit_length()} bits: the exact "
                             f"product holds {MAX_MODULUS_BITS} at most")
        self.n = n
        self.moduli = list(moduli)
        col = lambda vals: torch.tensor(vals, dtype=torch.int64, device=device)[:, None]
        self.q = col(self.moduli)
        psis = [psi(q, n) for q in self.moduli]
        self.psi = _powers(col(psis), n, self.q)
        self.psi_inv = _powers(col([pow(p, -1, q) for p, q in zip(psis, self.moduli)]), n, self.q)
        self.n_inv = col([pow(n, -1, q) for q in self.moduli])
        self.rev = _bitrev(n, device)
        # omega = psi^2: the twiddles of the stage of half-size h are
        # omega^(N / 2h * j), j < h, which is psi^(N / h * j)
        self.tw = {}
        h = 1
        while h < n:
            self.tw[h] = (self.psi[:, :: n // h][:, :h], self.psi_inv[:, :: n // h][:, :h])
            h *= 2

    def _dit(self, x: torch.Tensor, inverse: bool) -> torch.Tensor:
        """Cyclic transform by omega (or its inverse) of bit-reversed x; the
        result is in natural order."""
        q = self.q[:, :, None]
        lead, L, n = x.shape[:-2], x.shape[-2], self.n
        h = 1
        while h < n:
            xr = x.reshape(*lead, L, n // (2 * h), 2, h)
            u, v = xr[..., 0, :], mulmod(xr[..., 1, :], self.tw[h][inverse][:, None, :], q)
            x = torch.stack([(u + v) % q, (u - v) % q], dim=-2).reshape(*lead, L, n)
            h *= 2
        return x

    def forward(self, a: torch.Tensor) -> torch.Tensor:
        """[..., L, N] coefficients -> Lattigo's NTT domain."""
        x = mulmod(a, self.psi, self.q)[..., self.rev]
        return self._dit(x, False)[..., self.rev]

    def inverse(self, a: torch.Tensor) -> torch.Tensor:
        """[..., L, N] in Lattigo's NTT domain -> coefficients."""
        x = self._dit(a, True)
        return mulmod(mulmod(x, self.n_inv, self.q), self.psi_inv, self.q)

    def residues(self, coeffs: torch.Tensor) -> torch.Tensor:
        """Signed integer coefficients [..., N] (|c| < 2^62) -> [..., L, N]."""
        return coeffs[..., None, :] % self.q

    def out_of_range(self, x: torch.Tensor) -> int:
        """Words of x ([..., L, N]) outside [0, q)."""
        return int(((x < 0) | (x >= self.q)).sum())
