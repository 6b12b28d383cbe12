"""Polynomial samplers: uniform, discrete Gaussian, ternary.

Counterparts of ``lattigo_tpu/ops/samplers.py`` (ring/sampler.go,
ring/gaussianSampler.go, ring/ternarySampler.go).  Every sampler is a
function of an explicit ``torch.Generator`` that lives on the ring's device,
with the same distributions as the JAX package:

* Gaussian: inverse CDF over the 56-bit truncated PMF the reference's
  Knuth-Yao matrix encodes, with rejection on the truncated tail.
* Ternary: P(0)=p, else sign-uniform.
* Uniform: per-modulus masked rejection.

``torch.Generator`` cannot reproduce ``jax.random`` bits, so the two packages
agree in distribution, not bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lattigo_tpu_torch.ops import number_theory as nt
from lattigo_tpu_torch.ops import u64 as u


def make_generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _bits(gen: torch.Generator, shape, nbits: int) -> torch.Tensor:
    """Uniform ``nbits``-bit values (nbits <= 64) as int64 bit patterns."""
    draw = lambda b: torch.randint(
        0, 1 << b, shape, generator=gen, device=gen.device, dtype=torch.int64
    )
    if nbits <= 32:
        return draw(nbits)
    return (draw(nbits - 32) << 32) | draw(32)


def uniform_poly(gen, ring, lvl: int | None = None, batch=()) -> torch.Tensor:
    """Uniform in [0, q_i) per limb via masked rejection (sampler.go:11-66)."""
    L = ring.L if lvl is None else lvl + 1
    shape = (*batch, L, ring.n)
    mask = u.from_u64(np.array(ring.mask[:L], dtype=np.uint64).reshape(L, 1), ring.device)
    q = ring.q_[:L]
    x = _bits(gen, shape, 64) & mask
    bad = u.ge(x, q)
    while bool(bad.any()):
        x = torch.where(bad, _bits(gen, shape, 64) & mask, x)
        bad = u.ge(x, q)
    return x


def _gaussian_cdf_table(sigma: float, bound: int) -> tuple[np.ndarray, int]:
    """Cumulative 56-bit integer weights of |x| = 0..bound-1, halving the
    zero row exactly as the reference's Knuth-Yao matrix does
    (gaussianSampler.go:111-149)."""
    prec = 56
    weights = []
    for i in range(bound):
        g = (1.0 / (sigma * 2.5066282746310007)) * math.exp(-(i * i) / (2.0 * sigma * sigma))
        g *= 2.0 ** (prec - 1) if i == 0 else 2.0**prec
        x = int(g)
        if x == 0:
            break
        weights.append(x)
    cum = np.cumsum(weights, dtype=np.uint64)
    return cum, int(cum[-1])


def gaussian_poly(gen, ring, sigma: float = 3.2, bound: int = 19, lvl: int | None = None, batch=()) -> torch.Tensor:
    """Centered discrete Gaussian residues, one shared magnitude/sign draw
    mapped into every limb (gaussianSampler.go:211-240)."""
    L = ring.L if lvl is None else lvl + 1
    shape = (*batch, 1, ring.n)
    cum, total = _gaussian_cdf_table(sigma, bound)
    r = _bits(gen, shape, 56)
    bad = r >= total  # 56-bit values: signed compare is the unsigned one
    while bool(bad.any()):
        r = torch.where(bad, _bits(gen, shape, 56), r)
        bad = r >= total
    # magnitude = number of cumulative weights <= r (CDF inversion)
    cum_t = torch.from_numpy(cum.astype(np.int64)).to(ring.device)
    mag = (r[..., None] >= cum_t).sum(dim=-1)
    sign = _bits(gen, shape, 1)
    pos = mag.expand(*batch, L, ring.n)
    use_neg = (sign == 0) & (mag != 0)
    return torch.where(use_neg, ring.q_[:L] - pos, pos)


def ternary_poly(gen, ring, p: float = 0.5, montgomery: bool = False, lvl: int | None = None, batch=()) -> torch.Tensor:
    """Ternary residues with P(0)=p, P(+1)=P(-1)=(1-p)/2
    (ternarySampler.go:15-63)."""
    L = ring.L if lvl is None else lvl + 1
    shape = (*batch, 1, ring.n)
    is_zero = _bits(gen, shape, 30) < int(p * (1 << 30))
    return _ternary_map(ring, L, is_zero, _bits(gen, shape, 1), montgomery)


def ternary_sparse_poly(gen, ring, hw: int, montgomery: bool = False, lvl: int | None = None) -> torch.Tensor:
    """Exactly ``hw`` nonzero +-1 coefficients at uniformly drawn positions
    (ternarySampler.go:203-250)."""
    L = ring.L if lvl is None else lvl + 1
    n = ring.n
    pos = torch.randperm(n, generator=gen, device=gen.device)[:hw]
    is_zero = torch.ones((1, n), dtype=torch.bool, device=gen.device)
    is_zero[0, pos] = False
    return _ternary_map(ring, L, is_zero, _bits(gen, (1, n), 1), montgomery)


def _ternary_map(ring, L: int, is_zero, sign, montgomery: bool) -> torch.Tensor:
    """Map {0, +1, -1} draws onto per-modulus residues
    (values from ring/ring_context.go:109-123's ternary tables)."""
    if montgomery:
        one = [nt.mform(1, q) for q in ring.moduli[:L]]
        minus = [nt.mform(q - 1, q) for q in ring.moduli[:L]]
    else:
        one = [1] * L
        minus = [q - 1 for q in ring.moduli[:L]]
    col = lambda v: u.from_u64(np.array(v, dtype=np.uint64).reshape(L, 1), ring.device)
    val = torch.where(sign == 1, col(one), col(minus))
    return torch.where(is_zero, torch.zeros_like(val), val)
