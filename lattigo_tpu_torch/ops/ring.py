"""RNS polynomial ring context and coefficient-wise operations.

Counterpart of ``lattigo_tpu/ops/ring.py`` (and of the reference's
``ring.Context`` + ``ring/ring.go`` + ``ring/ntt.go``).

* A polynomial is one ``torch.int64`` tensor ``[..., L, N]`` holding uint64
  bit patterns (:mod:`lattigo_tpu_torch.ops.u64`); ``L`` is the number of RNS
  limbs actually carried.  Leading batch dimensions broadcast.
* Per-modulus constants are computed on the host with Python ints (bit for
  bit as ring/ring_context.go:68-209) and kept as ``[L, 1]`` tensors on the
  ring's ``device``.
* ``_ntt_simple`` / ``_intt_simple`` run the reference's merged-psi schedule
  as log2(N) vectorised butterfly stages; they are the plain version and the
  oracle of both CUDA kernels.  ``ntt_limbs`` / ``intt_limbs`` dispatch to
  the kernels (see :func:`Ring._route`).
"""

from __future__ import annotations

import numpy as np
import torch

from lattigo_tpu_torch import device as _device
from lattigo_tpu_torch.ops import modred, number_theory as nt
from lattigo_tpu_torch.ops import u64 as u

# Override of the NTT routing, for timing one kernel on the other's shapes
# and for running whole scheme ops on the plain schedule:
# None (route by shape) | "tile" | "mxu" | "plain".
FORCE_KERNEL = None

# Stacked calls of at least this many polys go to the four-step kernel, the
# rest to the row kernel.  This keeps the JAX package's routing; it is policy,
# not a measurement on the GPU.
_MXU_MIN_BATCH = 2


def _tbl(vals, shape, device) -> torch.Tensor:
    """Host ints (< 2^64) -> int64 tensor of uint64 bit patterns."""
    return u.from_u64(np.array(vals, dtype=np.uint64).reshape(shape), device)


class Ring:
    """Precomputed modular/NTT context for R_Q = Z_Q[X]/(X^N + 1)
    (ring/ring_context.go:18-51).  ``moduli`` must be distinct primes
    == 1 mod 2N for the NTT to be enabled."""

    def __init__(self, n: int, moduli, compute_ntt_tables: bool = True, device=None):
        if n & (n - 1) != 0:
            raise ValueError("ring degree must be a power of 2")
        self.device = _device.resolve(device)
        self.n = n
        self.log_n = n.bit_length() - 1
        self.moduli = [int(q) for q in moduli]
        self.L = len(self.moduli)
        self.modulus_bigint = 1
        for q in self.moduli:
            self.modulus_bigint *= q

        self.bred = [nt.bred_params(q) for q in self.moduli]
        self.qinv = [nt.mred_params(q) if q & (q - 1) != 0 else 0 for q in self.moduli]
        self.mask = [(1 << q.bit_length()) - 1 for q in self.moduli]

        Lx1 = (self.L, 1)
        dev = self.device
        self.q_ = _tbl(self.moduli, Lx1, dev)
        self.two_q_ = _tbl([2 * q for q in self.moduli], Lx1, dev)
        self.u0_ = _tbl([b[0] for b in self.bred], Lx1, dev)
        self.u1_ = _tbl([b[1] for b in self.bred], Lx1, dev)
        self.qinv_ = _tbl(self.qinv, Lx1, dev)

        # device tables the NTT kernels build at first use, keyed by them
        self.kernel_cache: dict = {}

        self.allows_ntt = False
        if compute_ntt_tables:
            self._gen_ntt_tables()

    # -- precomputation ----------------------------------------------------

    def _gen_ntt_tables(self):
        """ring/ring_context.go:129-209 (GenNTTParams)."""
        n = self.n
        for q in self.moduli:
            if not nt.is_prime(q) or q & (2 * n - 1) != 1:
                raise ValueError(f"modulus {q} does not allow NTT (need prime == 1 mod 2N)")

        self.rescale_params = [
            [nt.mform(pow(self.moduli[j], -1, self.moduli[i]), self.moduli[i]) for i in range(j)]
            for j in range(1, self.L)
        ]

        psi_rows, psi_inv_rows, n_inv, psis, psi_invs = [], [], [], [], []
        for q in self.moduli:
            p, pi, ninv, psi_m, psi_im = nt.psi_tables(q, n)
            psi_rows.append(p)
            psi_inv_rows.append(pi)
            n_inv.append(ninv)
            psis.append(psi_m)
            psi_invs.append(psi_im)
        self.psi_mont = psis
        self.psi_inv_mont = psi_invs
        self.n_inv_mont = n_inv
        self.ntt_psi_host = np.array(psi_rows, dtype=np.uint64)  # [L, N]
        self.ntt_psi_inv_host = np.array(psi_inv_rows, dtype=np.uint64)

        self._shoup_cache: dict = {}
        self.psi_ = u.from_u64(self.ntt_psi_host, self.device)
        self.psi_inv_ = u.from_u64(self.ntt_psi_inv_host, self.device)
        self.n_inv_ = _tbl(n_inv, (self.L, 1), self.device)
        self.allows_ntt = True

    def shoup_twiddles(self, inverse: bool) -> tuple[np.ndarray, np.ndarray]:
        """Plain + Shoup-quotient twiddle tables [L, N] (host) for the row
        kernel.  Multiplying by the plain twiddle with Shoup's precomputed
        floor(w*2^64/q) word agrees with the Montgomery butterfly mod q, and
        the final exact reduction makes the outputs bit-identical."""
        if inverse not in self._shoup_cache:
            mont = self.ntt_psi_inv_host if inverse else self.ntt_psi_host
            plain = np.empty_like(mont)
            shoup = np.empty_like(mont)
            for i, q in enumerate(self.moduli):
                row = mont[i].astype(object) * pow(1 << 64, -1, q) % q
                plain[i] = row.astype(np.uint64)
                shoup[i] = ((row << 64) // q).astype(np.uint64)
            self._shoup_cache[inverse] = (plain, shoup)
        return self._shoup_cache[inverse]

    # -- helpers -----------------------------------------------------------

    def level_of(self, x: torch.Tensor) -> int:
        return x.shape[-2] - 1

    def _tbl_rows(self, table: torch.Tensor, limbs: tuple[int, ...]) -> torch.Tensor:
        if tuple(limbs) == tuple(range(len(limbs))):
            return table[: len(limbs)]
        return table[list(limbs)]

    def limb_vector(self, limbs: tuple[int, ...]) -> torch.Tensor:
        """``limbs`` as an int32 vector on the device: the kernels index
        their per-limb tables through it."""
        key = ("limbs", tuple(limbs))
        if key not in self.kernel_cache:
            self.kernel_cache[key] = torch.tensor(limbs, dtype=torch.int32, device=self.device)
        return self.kernel_cache[key]

    def new_poly(self, lvl: int | None = None, batch=()) -> torch.Tensor:
        L = self.L if lvl is None else lvl + 1
        return torch.zeros((*batch, L, self.n), dtype=torch.int64, device=self.device)

    @staticmethod
    def _batch_of(x: torch.Tensor) -> int:
        out = 1
        for b in x.shape[:-2]:
            out *= int(b)
        return out

    # -- NTT ---------------------------------------------------------------

    def _route(self, x: torch.Tensor) -> str:
        """Which implementation serves a transform of ``x``.

        The routing is the JAX package's (``lattigo_tpu/ops/ring.py:207-237``):
        stacked calls (batch >= 2) at a supported N go to the int8 four-step
        kernel, everything else, N < 4096 included, to the row kernel.  Both
        wrappers take their plain version for a CPU tensor."""
        from lattigo_tpu_torch.ops import mxu_ntt

        if FORCE_KERNEL is not None:
            return FORCE_KERNEL
        if (self.n >= 4096 and mxu_ntt.supported(self.n)
                and self._batch_of(x) >= _MXU_MIN_BATCH):
            return "mxu"
        return "tile"

    def _transform(self, x: torch.Tensor, limbs, inverse: bool) -> torch.Tensor:
        limbs = tuple(int(l) for l in limbs)
        route = self._route(x)
        if route == "mxu":
            from lattigo_tpu_torch.ops import mxu_ntt

            return mxu_ntt.ntt_mxu(self, x, limbs, inverse=inverse)
        if route == "tile":
            from lattigo_tpu_torch.ops import tile_ntt

            return tile_ntt.ntt_tile(self, x, limbs, inverse=inverse)
        if route == "plain":
            return self._intt_simple(x, limbs) if inverse else self._ntt_simple(x, limbs)
        raise ValueError(f"unknown FORCE_KERNEL {route!r}")

    def ntt(self, x: torch.Tensor) -> torch.Tensor:
        """Forward negacyclic NTT over every carried limb (ring/ntt.go:53-86);
        output fully reduced in [0, q)."""
        return self.ntt_limbs(x, tuple(range(self.level_of(x) + 1)))

    def ntt_limbs(self, x: torch.Tensor, limbs: tuple[int, ...]) -> torch.Tensor:
        """Forward NTT of x[..., k, :] under modulus ``limbs[k]`` (the carried
        limbs need not be the prefix 0..L-1).  Inputs may be lazily reduced
        (< 4q)."""
        return self._transform(x, limbs, inverse=False)

    def intt(self, x: torch.Tensor) -> torch.Tensor:
        """Inverse negacyclic NTT (ring/ntt.go:89-139); exact output."""
        return self.intt_limbs(x, tuple(range(self.level_of(x) + 1)))

    def intt_limbs(self, x: torch.Tensor, limbs: tuple[int, ...]) -> torch.Tensor:
        """Inverse NTT with explicit limb-table indices; inputs < 4q."""
        return self._transform(x, limbs, inverse=True)

    def _ntt_simple(self, x: torch.Tensor, limbs: tuple[int, ...]) -> torch.Tensor:
        """Cooley-Tukey DIT over the bit-reversed merged-psi table, lazy
        butterflies, one exact BRedAdd at the end."""
        n = self.n
        psi = self._tbl_rows(self.psi_, limbs)
        q = self._tbl_rows(self.q_, limbs)[..., None]
        two_q = self._tbl_rows(self.two_q_, limbs)[..., None]
        qinv = self._tbl_rows(self.qinv_, limbs)[..., None]
        batch, L = x.shape[:-2], x.shape[-2]
        m = 1
        while m < n:  # m = 1, 2, 4, ..., N/2
            t = n // (2 * m)
            xr = x.reshape(*batch, L, m, 2, t)
            uu, vv = xr[..., 0, :], xr[..., 1, :]
            f = psi[:, m : 2 * m, None]
            # U in [0,4q) folded to [0,2q], V*psi in [0,2q)
            uu = torch.where(u.lt(two_q, uu), uu - two_q, uu)
            vv = modred.mred_constant(vv, f, q, qinv)
            x = torch.stack([uu + vv, uu + two_q - vv], dim=-2).reshape(*batch, L, n)
            m *= 2
        return modred.bred_add(
            x, self._tbl_rows(self.q_, limbs), self._tbl_rows(self.u0_, limbs)
        )

    def _intt_simple(self, x: torch.Tensor, limbs: tuple[int, ...]) -> torch.Tensor:
        """Gentleman-Sande butterflies, then * N^-1 with an exact reduction.
        Inputs below 4q are folded below 2q first, as the row kernel does."""
        n = self.n
        psi_inv = self._tbl_rows(self.psi_inv_, limbs)
        q2 = self._tbl_rows(self.q_, limbs)
        two_q2 = self._tbl_rows(self.two_q_, limbs)
        qinv2 = self._tbl_rows(self.qinv_, limbs)
        q, two_q, qinv = q2[..., None], two_q2[..., None], qinv2[..., None]
        for _ in range(2):
            x = torch.where(u.lt(two_q2, x), x - two_q2, x)
        batch, L = x.shape[:-2], x.shape[-2]
        h = n // 2
        while h >= 1:  # h = N/2, N/4, ..., 1
            t = n // (2 * h)
            xr = x.reshape(*batch, L, h, 2, t)
            uu, vv = xr[..., 0, :], xr[..., 1, :]
            f = psi_inv[:, h : 2 * h, None]
            x_new = uu + vv
            x_new = torch.where(u.lt(two_q, x_new), x_new - two_q, x_new)
            y_new = modred.mred_constant(uu + two_q - vv, f, q, qinv)
            x = torch.stack([x_new, y_new], dim=-2).reshape(*batch, L, n)
            h //= 2
        return modred.mred(x, self._tbl_rows(self.n_inv_, limbs), q2, qinv2)

    # -- coefficient-wise ops (ring/ring.go) -------------------------------

    def _qc(self, x: torch.Tensor):
        lvl = self.level_of(x)
        return (
            self.q_[: lvl + 1],
            self.u0_[: lvl + 1],
            self.u1_[: lvl + 1],
            self.qinv_[: lvl + 1],
        )

    def add(self, a, b):
        return modred.cred(a + b, self._qc(a)[0])

    def sub(self, a, b):
        q = self._qc(a)[0]
        return modred.cred(a + q - b, q)

    def neg(self, a):
        return self._qc(a)[0] - a

    def reduce(self, a):
        q, u0, _, _ = self._qc(a)
        return modred.bred_add(a, q, u0)

    def mform(self, a):
        q, u0, u1, _ = self._qc(a)
        return modred.mform(a, q, u0, u1)

    def mul_coeffs_montgomery(self, a, b):
        """a .* b * 2^-64 mod q (one operand in Montgomery form)."""
        q, _, _, qinv = self._qc(a)
        return modred.mred(a, b, q, qinv)

    def mul_coeffs_montgomery_and_add(self, a, b, c):
        q, _, _, qinv = self._qc(a)
        return modred.cred(modred.mred(a, b, q, qinv) + c, q)

    def mul_coeffs_montgomery_and_sub(self, a, b, c):
        q, _, _, qinv = self._qc(a)
        return modred.cred(q - modred.mred(a, b, q, qinv) + c, q)

    def _scalar_tbl(self, a, fn) -> torch.Tensor:
        lvl = self.level_of(a)
        return _tbl([fn(q) for q in self.moduli[: lvl + 1]], (lvl + 1, 1), a.device)

    def mul_scalar_bigint(self, a, scalar: int):
        """a * scalar mod q per limb, arbitrary-precision scalar."""
        mont = self._scalar_tbl(a, lambda q: nt.mform(scalar % q, q))
        q, _, _, qinv = self._qc(a)
        return modred.mred(a, mont, q, qinv)

    mul_scalar = mul_scalar_bigint

    def add_scalar_bigint(self, a, scalar: int):
        c = self._scalar_tbl(a, lambda q: scalar % q)
        return modred.cred(a + c, self._qc(a)[0])

    def sub_scalar_bigint(self, a, scalar: int):
        c = self._scalar_tbl(a, lambda q: (q - scalar % q) % q)
        return modred.cred(a + c, self._qc(a)[0])

    # -- host <-> device coefficient conversion ----------------------------

    def set_coeffs_bigint(self, coeffs, lvl: int | None = None) -> torch.Tensor:
        """Arbitrary-precision coefficients -> RNS residues
        (ring/ring_context.go:424-467)."""
        L = self.L if lvl is None else lvl + 1
        co = np.asarray(coeffs, dtype=object)
        rows = np.empty((L, self.n), dtype=np.uint64)
        for i in range(L):
            rows[i] = (co % self.moduli[i]).astype(np.uint64)
        return u.from_u64(rows, self.device)

    def poly_to_bigint(self, x: torch.Tensor) -> list[int]:
        """CRT reconstruction over the carried limbs
        (ring/ring_context.go:384-421)."""
        arr = u.to_u64(x)
        L = arr.shape[-2]
        mod = 1
        for q in self.moduli[:L]:
            mod *= q
        acc = np.zeros(self.n, dtype=object)
        for i in range(L):
            qi = self.moduli[i]
            crt = mod // qi
            crt *= pow(crt, -1, qi)
            acc += arr[i].astype(object) * crt
        return (acc % mod).tolist()
