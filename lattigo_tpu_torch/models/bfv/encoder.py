"""BFV SIMD encoder: Z_t^N <-> R_t <-> R_Q lifted by Delta = floor(Q/t)
(bfv/encoder.go)."""

from __future__ import annotations

import functools

import numpy as np

from lattigo_tpu_torch.models.bfv.context import GALOIS_GEN, get_context
from lattigo_tpu_torch.models.bfv.elements import Plaintext
from lattigo_tpu_torch.ops import modred_kernel as mk
from lattigo_tpu_torch.ops import u64 as u
from lattigo_tpu_torch.ops.number_theory import bit_reverse


@functools.lru_cache(maxsize=None)
def index_matrix(n: int) -> np.ndarray:
    """Slot -> coefficient position: bit-reversed orbit of the generator 5
    (bfv/encoder.go:36-58)."""
    log_n = n.bit_length() - 1
    row = n >> 1
    m = n << 1
    idx = np.empty(n, dtype=np.int64)
    pos = 1
    for i in range(row):
        idx[i] = bit_reverse((pos - 1) >> 1, log_n)
        idx[i | row] = bit_reverse((m - pos - 1) >> 1, log_n)
        pos = pos * GALOIS_GEN & (m - 1)
    return idx


class Encoder:
    def __init__(self, params, device=None):
        self.ctx = get_context(params, device)
        self.params = self.ctx.params
        self.idx = index_matrix(self.ctx.n)
        self._delta_mont = u.from_u64(
            np.array(self.ctx.delta_mont, dtype=np.uint64).reshape(-1, 1), self.ctx.device
        )

    def encode_uint(self, coeffs) -> Plaintext:
        """bfv/encoder.go:71-118: scatter -> InvNTT mod t -> lift by Delta."""
        vals = np.zeros(self.ctx.n, dtype=np.uint64)
        coeffs = np.asarray(coeffs, dtype=np.uint64)
        vals[self.idx[: len(coeffs)]] = coeffs
        return self._encode(vals)

    def encode_int(self, coeffs) -> Plaintext:
        t = self.params.t
        coeffs = np.asarray(coeffs, dtype=np.int64)
        return self.encode_uint(np.where(coeffs < 0, t + coeffs, coeffs).astype(np.uint64))

    def _encode(self, vals: np.ndarray) -> Plaintext:
        ctx = self.ctx
        ring_q = ctx.ring_q
        pt_t = ctx.ring_t.intt(u.from_u64(vals.reshape(1, -1), ctx.device))
        # lift: pt_q[i] = MRed(pt_t, deltaMont[i]) (bfv/encoder.go:121-138)
        return Plaintext(mk.mred(pt_t, self._delta_mont, ring_q.q_, ring_q.qinv_))

    def decode_uint(self, pt: Plaintext) -> np.ndarray:
        """bfv/encoder.go:140-156: t/Q scale -> NTT mod t -> gather.  A
        plaintext with leading dims decodes to [..., N]."""
        scaled = self.ctx.scaler_t.scale(pt.value, 1)
        vals = u.to_u64(self.ctx.ring_t.ntt(scaled))[..., 0, :]
        return vals[..., self.idx]

    def decode_int(self, pt: Plaintext) -> np.ndarray:
        vals = self.decode_uint(pt).astype(np.int64)
        t = self.params.t
        return np.where(vals > t >> 1, vals - t, vals)
