"""Deterministic keyed PRNG and common-reference-polynomial (CRP) stream.

Counterpart of ``lattigo_tpu/utils/prng.py`` (utils/prng.go: a keyed
blake2b-512 hash chain with a clock counter; ring/prng.go: the
clock-addressable uniform polynomial stream).  Every party seeded alike and
clocked to the same cycle derives the same bytes, so the stream replaces
the broadcast channel of the threshold protocols.  The walk runs on the
host; each polynomial is copied to the ring's device once.
"""

from __future__ import annotations

import ctypes
import hashlib

import numpy as np
import torch

from lattigo_tpu_torch import native
from lattigo_tpu_torch.ops import u64 as u


class PRNG:
    """Keyed blake2b-512 hash chain (utils/prng.go:13-73): ``clock()``
    emits the 64-byte digest of everything absorbed so far and absorbs it."""

    def __init__(self, key: bytes | None = None):
        self._key = key or b""
        self._h = hashlib.blake2b(key=self._key, digest_size=64)
        self.clock_cycle = 0
        self._seed = b""

    def seed(self, seed: bytes | None):
        self._h = hashlib.blake2b(key=self._key, digest_size=64)
        self._seed = seed or b""
        self._h.update(self._seed)
        self.clock_cycle = 0

    def get_seed(self) -> bytes:
        return self._seed

    def clock(self) -> bytes:
        digest = self._h.copy().digest()
        self._h.update(digest)
        self.clock_cycle += 1
        return digest

    def set_clock(self, n: int):
        if self.clock_cycle > n:
            raise ValueError("cannot set prng clock to a previous state")
        while self.clock_cycle != n:
            self.clock()


class CRPGenerator:
    """Uniform polynomials of ``ring`` from the hash chain
    (ring/prng.go:11-103), as int64 tensors on ``ring.device``."""

    def __init__(self, key: bytes | None, ring):
        self.prng = PRNG(key)
        self.ring = ring
        self.masks = ring.mask

    def get_clock(self) -> int:
        return self.prng.clock_cycle

    def seed(self, seed: bytes | None):
        self.prng.seed(seed)

    def set_clock(self, n: int):
        self.prng.set_clock(n)

    def _clock_host(self) -> np.ndarray:
        """One polynomial [L, N] as uint64 on the host, in the exact byte
        order of ring/prng.go:77-103 (coefficient i outer, limb j inner).
        Digests are drawn ahead from a copy of the hash state; exactly the
        consumed ones are then absorbed into the real chain, which is
        stream-equivalent to absorbing them one clock at a time."""
        ring = self.ring
        L, N = ring.L, ring.n
        masks = np.array(self.masks, dtype=np.uint64)
        qs = np.array(ring.moduli, dtype=np.uint64)
        spec = self.prng._h.copy()
        digests: list[bytes] = []

        def fetch(n_dig: int) -> np.ndarray:
            chunks = []
            for _ in range(n_dig):
                d = spec.copy().digest()
                spec.update(d)
                digests.append(d)
                chunks.append(d)
            return np.frombuffer(b"".join(chunks), dtype=">u8").astype(np.uint64)

        words_per_coeff = sum((int(m) + 1) / float(q) for q, m in zip(ring.moduli, self.masks))
        need_words = int(N * words_per_coeff * 1.02) + 8 * L + 16
        words = fetch((need_words + 7) // 8)
        out = np.empty((L, N), dtype=np.uint64)
        while True:
            k = _walk(words, masks, qs, L, N, out)
            if k >= 0:
                break
            words = np.concatenate([words, fetch(max(64, len(words) // 32))])
        consumed = (int(k) + 7) // 8
        self.prng._h.update(b"".join(digests[:consumed]))
        self.prng.clock_cycle += consumed
        return out

    def clock_poly(self) -> torch.Tensor:
        """One uniform polynomial over the full basis; advances the clock by
        at least one cycle."""
        return u.from_u64(self._clock_host(), self.ring.device)

    def clock_polys(self, count: int) -> torch.Tensor:
        """``count`` consecutive polynomials stacked as one [count, L, N]
        tensor (the beta-stacked CRP of the key-generation protocols), with
        one host-to-device copy."""
        return u.from_u64(np.stack([self._clock_host() for _ in range(count)]), self.ring.device)

    def clock_poly_scalar(self) -> torch.Tensor:
        """The literal ring/prng.go:77-103 loop, one word at a time: the
        exactness twin of :meth:`clock_poly` for tests."""
        ring = self.ring
        out = np.empty((ring.L, ring.n), dtype=np.uint64)
        buf = self.prng.clock()
        for i in range(ring.n):
            for j, qi in enumerate(ring.moduli):
                while True:
                    if len(buf) < 8:
                        buf = self.prng.clock()
                    coeff = int.from_bytes(buf[:8], "big") & self.masks[j]
                    buf = buf[8:]
                    if coeff < qi:
                        break
                out[j, i] = coeff
        return u.from_u64(out, ring.device)


def _walk(words: np.ndarray, masks: np.ndarray, qs: np.ndarray, L: int, N: int,
          out: np.ndarray) -> int:
    """Exact-order rejection walk: fill out[j, i] (i outer, j inner) from the
    word stream; return the words consumed, or -1 if the stream ran dry."""
    lib = native.crp_walk_lib()
    if lib is None:
        return _walk_numpy(words, masks, qs, L, N, out)
    W = np.ascontiguousarray(words, dtype=np.uint64)
    m = np.ascontiguousarray(masks, dtype=np.uint64)
    q = np.ascontiguousarray(qs, dtype=np.uint64)
    if out.dtype != np.uint64 or not out.flags.c_contiguous or out.shape != (L, N):
        raise ValueError("out must be a C-contiguous uint64 array of shape (L, N)")
    if len(m) < L or len(q) < L:
        raise ValueError("masks and moduli need one entry per limb")
    pt = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
    return int(lib.crp_walk(pt(W), len(W), pt(m), pt(q), L, N, pt(out)))


def _walk_numpy(words, masks, qs, L, N, out) -> int:
    """The walk in NumPy: acceptance table per phase and run-jumping.
    Between rejections the phase advances deterministically, so each
    accepted run is validated with one diagonal gather; Python iterates
    only per rejection."""
    M = len(words)
    A = (words[:, None] & masks[None, :]) < qs[None, :]  # [M, L]
    vals = words[:, None] & masks[None, :]
    slot = 0  # global slot index = i * L + j
    k = 0
    while slot < N * L:
        remaining = N * L - slot
        span = min(remaining, M - k)
        if span <= 0:
            return -1
        idx = np.arange(span)
        phases = (slot + idx) % L
        ok = A[k + idx, phases]
        bad = np.argmin(ok) if not ok.all() else span
        if bad > 0:
            i_coord = (slot + idx[:bad]) // L
            j_coord = phases[:bad]
            out[j_coord, i_coord] = vals[k + idx[:bad], j_coord]
            slot += bad
            k += bad
        if bad < span:
            k += 1  # the rejected word
        elif span < remaining:
            return -1
    return k
