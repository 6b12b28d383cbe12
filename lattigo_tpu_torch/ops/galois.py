"""Galois automorphisms X^i -> X^(gen*i) on R_Q, in and out of the NTT
domain (ring/ring_galois.go).

Counterpart of ``lattigo_tpu/ops/galois.py``.  The index and sign tables are
built on the host with vectorised numpy, once per (Galois element, N); on
the device a permutation is one gather along the coefficient axis (plus a
sign select in the coefficient domain), with the index tensor cached per
(Galois element, N, device).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lattigo_tpu_torch.ops.number_theory import bit_reverse_array


def gen_galois_params(n: int, gen: int) -> list[int]:
    """Galois elements gen^i mod 2N for column rotations
    (ring/ring_galois.go:9-26)."""
    m = n << 1
    out = [1]
    for _ in range(1, n >> 1):
        out.append(out[-1] * gen % m)
    return out


@functools.lru_cache(maxsize=None)
def permute_ntt_index(gal_el: int, n: int) -> np.ndarray:
    """Gather index table mapping the NTT-domain (bit-reversed) layout through
    the automorphism X -> X^gal_el (ring/ring_galois.go:29-52)."""
    log_n = n.bit_length() - 1
    mask = (n << 1) - 1
    t1 = 2 * bit_reverse_array(np.arange(n, dtype=np.int64), log_n) + 1
    t2 = ((gal_el * t1) & mask) >> 1  # (odd - 1) >> 1
    return bit_reverse_array(t2, log_n).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _permute_tables(gal_el: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Coefficient-domain tables: out[k] = (-1)^flip[k] * in[src[k]]
    (inverse of ring/ring_galois.go:106-127's scatter)."""
    log_n = n.bit_length() - 1
    i = np.arange(n, dtype=np.int64)
    raw = i * gal_el
    src = np.empty(n, dtype=np.int32)
    flip = np.empty(n, dtype=np.uint32)
    src[raw & (n - 1)] = i
    flip[raw & (n - 1)] = (raw >> log_n) & 1
    return src, flip


_device_tables: dict = {}


def _on_device(kind: str, gal_el: int, n: int, device: torch.device):
    key = (kind, gal_el, n, str(device))
    if key not in _device_tables:
        if kind == "ntt":
            val = torch.from_numpy(permute_ntt_index(gal_el, n).astype(np.int64)).to(device)
        else:
            src, flip = _permute_tables(gal_el, n)
            val = (torch.from_numpy(src.astype(np.int64)).to(device),
                   torch.from_numpy(flip.astype(bool)).to(device))
        _device_tables[key] = val
    return _device_tables[key]


def ntt_index(gal_el: int, n: int, device) -> torch.Tensor:
    """:func:`permute_ntt_index` as an int64 vector on ``device``, cached:
    coefficient k of the permuted poly is coefficient ``index[k]`` of the
    input."""
    return _on_device("ntt", gal_el, n, torch.device(device))


def permute_ntt(x: torch.Tensor, gal_el: int) -> torch.Tensor:
    """NTT-domain automorphism: one gather along the coefficient axis
    (ring/ring_galois.go:55-103)."""
    return torch.index_select(x, -1, ntt_index(gal_el, x.shape[-1], x.device))


def permute_ntt_stack(x: torch.Tensor, gal_els) -> torch.Tensor:
    """:func:`permute_ntt` of ``x`` [..., L, N] under each of ``gal_els``,
    stacked [len(gal_els), ..., L, N], in one gather; the stacked
    :func:`ntt_index` vectors are cached as they are."""
    n, device = x.shape[-1], x.device
    key = ("ntt_stack", tuple(gal_els), n, str(device))
    if key not in _device_tables:
        _device_tables[key] = torch.stack([ntt_index(g, n, device) for g in gal_els])
    full = (len(gal_els), *x.shape)
    index = _device_tables[key].view(len(gal_els), *(1,) * (x.ndim - 1), n)
    return torch.gather(x.expand(full), -1, index.expand(full))


def permute(ring, x: torch.Tensor, gal_el: int) -> torch.Tensor:
    """Coefficient-domain automorphism with a sign flip on wrap-around."""
    src, flip = _on_device("coeff", gal_el, ring.n, x.device)
    g = torch.index_select(x, -1, src)
    q = ring.q_[: ring.level_of(x) + 1]
    neg = torch.where(g == 0, g, q - g)  # q - 0 == q: a zero stays zero
    return torch.where(flip, neg, g)
