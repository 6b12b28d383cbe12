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

A sampler may run inside a CUDA graph capture (a ``tjit`` program that
draws noise).  Its tables then come from the ring's cache, every draw
reports its generator to the entry being built (``tjit.note_generator``,
which registers it with the graph so that each replay draws fresh values),
and a rejection loop, which would need the host to test its condition,
draws all its rounds at once and keeps each value's first accepted
candidate: the same distribution, except where every round rejects, which
happens with probability below 2^-CAPTURE_REJECT_BITS per value.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lattigo_tpu_torch import tjit
from lattigo_tpu_torch.ops import number_theory as nt
from lattigo_tpu_torch.ops import u64 as u

# a rejection loop in a captured graph draws enough rounds that a value
# every round rejects has probability below 2^-CAPTURE_REJECT_BITS
CAPTURE_REJECT_BITS = 80


def make_generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _bits(gen: torch.Generator, shape, nbits: int) -> torch.Tensor:
    """Uniform ``nbits``-bit values (nbits <= 64) as int64 bit patterns."""
    tjit.note_generator(gen)
    draw = lambda b: torch.randint(
        0, 1 << b, shape, generator=gen, device=gen.device, dtype=torch.int64
    )
    if nbits <= 32:
        return draw(nbits)
    return (draw(nbits - 32) << 32) | draw(32)


def _rejection(gen, shape, draw, rejects, p_reject: float) -> torch.Tensor:
    """``draw(shape)``, each value rejected by ``rejects`` drawn again until
    none is.  Eagerly the host tests the condition after every round.  In a
    CUDA graph capture every round is drawn at once (``p_reject``: the most
    a round rejects) and each value keeps its first accepted candidate."""
    x = draw(shape)
    capturing = gen.device.type == "cuda" and torch.cuda.is_current_stream_capturing()
    if not capturing:
        bad = rejects(x)
        while bool(bad.any()):
            x = torch.where(bad, draw(shape), x)
            bad = rejects(x)
        return x
    if p_reject <= 0:
        return x
    rounds = math.ceil(CAPTURE_REJECT_BITS / -math.log2(p_reject))
    cands = torch.cat([x[None], draw((rounds, *shape))])
    first = (~rejects(cands)).to(torch.int32).argmax(dim=0, keepdim=True)
    return cands.gather(0, first)[0]


def _col(ring, vals, L: int) -> torch.Tensor:
    return u.from_u64(np.array(vals, dtype=np.uint64).reshape(L, 1), ring.device)


def uniform_poly(gen, ring, lvl: int | None = None, batch=()) -> torch.Tensor:
    """Uniform in [0, q_i) per limb via masked rejection (sampler.go:11-66)."""
    L = ring.L if lvl is None else lvl + 1
    shape = (*batch, L, ring.n)
    mask = ring._cached(("sampler_mask", L), lambda: _col(ring, ring.mask[:L], L))
    q = ring.q_[:L]
    p_reject = max(1 - qi / (m + 1) for qi, m in zip(ring.moduli[:L], ring.mask[:L]))
    x = _rejection(gen, shape, lambda s: _bits(gen, s, 64) & mask, lambda v: u.ge(v, q), p_reject)
    # a value that every captured round rejected lies below 2q
    return torch.where(u.ge(x, q), x - q, x)


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
    # 56-bit values: the signed compare is the unsigned one
    r = _rejection(gen, shape, lambda s: _bits(gen, s, 56), lambda v: v >= total,
                   1 - total / 2.0**56)
    # magnitude = number of cumulative weights <= r (CDF inversion)
    cum_t = ring._cached(("gaussian_cdf", sigma, bound),
                         lambda: torch.from_numpy(cum.astype(np.int64)).to(ring.device))
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

    def columns():
        qs = ring.moduli[:L]
        if montgomery:
            return _col(ring, [nt.mform(1, q) for q in qs], L), _col(ring, [nt.mform(q - 1, q) for q in qs], L)
        return _col(ring, [1] * L, L), _col(ring, [q - 1 for q in qs], L)

    one, minus = ring._cached(("ternary", L, montgomery), columns)
    val = torch.where(sign == 1, one, minus)
    return torch.where(is_zero, torch.zeros_like(val), val)
