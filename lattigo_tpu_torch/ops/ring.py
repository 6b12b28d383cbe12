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
  oracle of the CUDA kernels.  ``ntt_limbs`` / ``intt_limbs`` dispatch to
  the kernels (see :func:`Ring._route`), or, inside a
  :func:`lattigo_tpu_torch.parallel.cross_ntt.sharded_ntt` block, to the
  cross-rank four-step transform, as the JAX package's ring does
  (``lattigo_tpu/ops/ring.py:197-205``, ``:289-297``).
* The JAX package's ``Ring.ntt_roll`` is a TPU schedule of the same
  transform that :meth:`Ring.ntt` computes, and has no twin here.
* Spans and counters (``utils/profiling.py``): every transform is the span
  ``ring.ntt`` / ``ring.intt`` with its route, and adds its rows
  (``x.numel() // N``) to the counter ``ntt.rows.<route>``; every build of
  a ring's constant tables (the constructor, a miss of :meth:`Ring._cached`
  or :meth:`Ring.kernel_table`) is the span ``ring.tables``, nested builds
  inside the outermost one.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict

import numpy as np
import torch

from lattigo_tpu_torch import device as _device
from lattigo_tpu_torch import tjit
from lattigo_tpu_torch.ops import modred, modred_kernel as mk, number_theory as nt
from lattigo_tpu_torch.ops import u64 as u
from lattigo_tpu_torch.parallel import cross_ntt
from lattigo_tpu_torch.utils import profiling

# Override of the NTT routing, for timing one kernel on the other's shapes
# and for running whole scheme ops on the plain schedule:
# None (route by shape) | "tile" | "mxu" | "passes" | "plain".
FORCE_KERNEL = None

# Stacked calls of at least this many polys go to the four-step kernel, the
# rest to the row kernel.  This keeps the JAX package's routing; it is policy,
# not a measurement on the GPU.
_MXU_MIN_BATCH = 2
# entries of a Ring's table cache (scalar columns, rotation twists, index
# tables); the least recently used one goes first, so that user-chosen
# scalars cannot grow it without bound
OP_CACHE_SIZE = 64
# the list that record_transforms() fills, while one is open
_RECORD: list | None = None
# a table build is open (its span holds the builds nested in it)
_BUILDING = False


def build_tables(build, *args):
    """``build(*args)`` in the span ``ring.tables``, or inside the open one."""
    global _BUILDING
    if _BUILDING:
        return build(*args)
    _BUILDING = True
    try:
        with profiling.span("ring.tables"):
            return build(*args)
    finally:
        _BUILDING = False


def _int32_vector(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int32, device=device)


@contextlib.contextmanager
def record_transforms():
    """Yields a list that collects ``(ring, shape, limbs, inverse, route)``
    for every transform made in the block: the shapes a path gives each
    kernel (route ``"cross"``: the cross-rank four-step transform)."""
    global _RECORD
    prev, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = prev


def distinct_transforms(calls) -> list[tuple]:
    """The distinct ``(moduli, shape, limbs, inverse, route)`` among the
    calls ``record_transforms`` collected: host values, which a rank can
    send to its parent."""
    return sorted({(tuple(r.moduli), shape, limbs, inverse, route)
                   for r, shape, limbs, inverse, route in calls})


def launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel since the last reset: the NTT kernels by
    direction (``ntt_tile_fwd``, ``ntt_tile_inv``, ``ntt_mxu_fwd``, ...),
    then the modular pass (``modred``), the basis extension (``mod_up``)
    and the key switch's inner product (``key_switch``)."""
    out = {}
    for name, w in _kernel_wrappers().items():
        out[name + "_fwd"] = w.launches - w.inverse_launches
        out[name + "_inv"] = w.inverse_launches
    for name, w in _modarith_wrappers().items():
        out[name] = w.launches
    return out


def reset_launch_counts() -> None:
    for w in _kernel_wrappers().values():
        w.launches = w.inverse_launches = 0
    for w in _modarith_wrappers().values():
        w.launches = w.copies = 0


def _kernel_wrappers() -> dict:
    from lattigo_tpu_torch.ops import mxu_ntt, pallas_ntt, tile_ntt

    return {"ntt_tile": tile_ntt.ntt_tile, "ntt_mxu": mxu_ntt.ntt_mxu,
            "ntt_passes": pallas_ntt.ntt_passes}


def _modarith_wrappers() -> dict:
    from lattigo_tpu_torch.ops import basis_ext, key_switch

    return {"modred": mk.modarith, "mod_up": basis_ext.mod_up,
            "key_switch": key_switch.inner_product}


def _tbl(vals, shape, device) -> torch.Tensor:
    """Host ints (< 2^64) -> int64 tensor of uint64 bit patterns."""
    return u.from_u64(np.array(vals, dtype=np.uint64).reshape(shape), device)


class Ring:
    """Precomputed modular/NTT context for R_Q = Z_Q[X]/(X^N + 1)
    (ring/ring_context.go:18-51).  ``moduli`` must be distinct primes
    == 1 mod 2N for the NTT to be enabled."""

    def __init__(self, n: int, moduli, compute_ntt_tables: bool = True, device=None):
        build_tables(lambda: self._init(n, moduli, compute_ntt_tables, device))

    def _init(self, n, moduli, compute_ntt_tables, device):
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

        # device tables the NTT kernels build at first use, keyed by them;
        # a tjit entry being built keeps every table it reads alive
        self.kernel_cache: dict = tjit.TableCache()
        # per-limb scalar columns, rotation twists and index tables, built at
        # first use so that repeated calls copy nothing from the host
        self._op_cache: OrderedDict = OrderedDict()

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
        """The rows ``limbs`` of a per-limb table: a slice for a prefix, else
        a gather through the cached index vector, so that no call copies an
        index from the host (CUDA graphs capture these calls)."""
        if tuple(limbs) == tuple(range(len(limbs))):
            return table[: len(limbs)]
        return table.index_select(0, self.limb_vector(limbs))

    def limb_vector(self, limbs: tuple[int, ...]) -> torch.Tensor:
        """``limbs`` as an int32 vector on the device: the kernels index
        their per-limb tables through it."""
        return self.kernel_table(("limbs", tuple(limbs)), _int32_vector, limbs, self.device)

    def kernel_table(self, key, build, *args):
        """The entry ``key`` of ``kernel_cache`` (the kernels' device
        tables), built by ``build(*args)`` when missing."""
        got = self.kernel_cache.get(key)
        if got is None:
            got = self.kernel_cache[key] = build_tables(build, *args)
        return got

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

        Below N = 256 (``tile_ntt.MIN_N``) every transform takes the plain
        schedule (``"plain"``), on any device, as the JAX package sends every
        N < 4096 to its ``_ntt_simple`` (``lattigo_tpu/ops/ring.py:181``,
        ``:237``).  From N = 256 to 16384 the routing is the JAX package's
        (``lattigo_tpu/ops/ring.py:207-237``): stacked calls (batch >= 2) at
        a supported N go to the int8 four-step kernel, everything else,
        N < 4096 included, to the row kernel.  Every transform the row kernel
        cannot hold (N > 16384) and the four-step kernel does not take goes
        to the long-row (cluster) kernel: N = 65536 at any batch, N = 32768
        at batch 1.  This departs from the JAX package, which sends N = 65536 at batch
        < 64 to its row kernel because a TPU holds a 512 KB row in VMEM; no
        H100 block holds one (227 KB of shared memory at most).
        ``FORCE_KERNEL`` overrides all of this.  Every wrapper takes its
        plain version for a CPU tensor."""
        from lattigo_tpu_torch.ops import mxu_ntt, tile_ntt

        if FORCE_KERNEL is not None:
            return FORCE_KERNEL
        if self.n < tile_ntt.MIN_N:
            return "plain"
        if (self.n >= 4096 and mxu_ntt.supported(self.n)
                and self._batch_of(x) >= _MXU_MIN_BATCH):
            return "mxu"
        if self.n > tile_ntt.MAX_N:
            return "passes"
        return "tile"

    def _transform(self, x: torch.Tensor, limbs, inverse: bool) -> torch.Tensor:
        limbs = tuple(int(l) for l in limbs)
        group = cross_ntt.active_for(self.n)
        route = "cross" if group is not None else self._route(x)
        if _RECORD is not None:
            _RECORD.append((self, tuple(x.shape), limbs, inverse, route))
        profiling.count("ntt.rows." + route, x.numel() // self.n)
        return profiling.run_in_span("ring.intt" if inverse else "ring.ntt", route, self._dispatch,
                                     x, limbs, inverse, route, group)

    def _dispatch(self, x, limbs, inverse, route, group):
        if route == "cross":
            # no kernel: the JAX package's cross-chip path is collectives
            # and tensor butterflies too
            return cross_ntt.ntt_four_step(self, x, group, inverse=inverse, limbs=limbs)
        if route == "mxu":
            from lattigo_tpu_torch.ops import mxu_ntt

            return mxu_ntt.ntt_mxu(self, x, limbs, inverse=inverse)
        if route == "tile":
            from lattigo_tpu_torch.ops import tile_ntt

            return tile_ntt.ntt_tile(self, x, limbs, inverse=inverse)
        if route == "passes":
            from lattigo_tpu_torch.ops import pallas_ntt

            return pallas_ntt.ntt_passes(self, x, limbs, inverse=inverse)
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
        return mk.add(a, b, self._qc(a)[0])

    def sub(self, a, b):
        return mk.sub(a, b, self._qc(a)[0])

    def neg(self, a):
        return mk.neg(a, self._qc(a)[0])

    def reduce(self, a):
        q, u0, _, _ = self._qc(a)
        return mk.bred_add(a, q, u0)

    def mform(self, a):
        q, u0, u1, _ = self._qc(a)
        return mk.mform(a, q, u0, u1)

    def inv_mform(self, a):
        q, _, _, qinv = self._qc(a)
        return mk.inv_mform(a, q, qinv)

    def mul_coeffs_montgomery(self, a, b):
        """a .* b * 2^-64 mod q (one operand in Montgomery form)."""
        q, _, _, qinv = self._qc(a)
        return mk.mred(a, b, q, qinv)

    def mul_coeffs_montgomery_limbs(self, a, b, limbs: tuple[int, ...]):
        """mul_coeffs_montgomery where limb row k of a/b lives under modulus
        ``limbs[k]`` (non-prefix limb selections: stacked key-switch planes)."""
        q = self._tbl_rows(self.q_, limbs)
        return mk.mred(a, b, q, self._tbl_rows(self.qinv_, limbs))

    def reduce_limbs(self, a, limbs: tuple[int, ...]):
        """BRedAdd exact reduction with explicit limb-table indices."""
        return mk.bred_add(a, self._tbl_rows(self.q_, limbs), self._tbl_rows(self.u0_, limbs))

    def mul_coeffs_montgomery_and_add(self, a, b, c):
        q, _, _, qinv = self._qc(a)
        return mk.mred_add(a, b, c, q, qinv)

    def mul_coeffs_montgomery_and_sub(self, a, b, c):
        q, _, _, qinv = self._qc(a)
        return mk.mred_sub(a, b, c, q, qinv)

    def _cached(self, key, build):
        """The table under ``key`` in the ring's LRU cache of at most
        ``OP_CACHE_SIZE`` entries, built by ``build()`` when missing.  A
        tjit entry being built keeps the table alive after its eviction
        (``tjit.note_table``): its graph reads the table's memory."""
        cache = self._op_cache
        if key in cache:
            cache.move_to_end(key)
            return tjit.note_table(cache[key])
        cache[key] = value = build_tables(build)
        if len(cache) > OP_CACHE_SIZE:
            cache.popitem(last=False)
        return tjit.note_table(value)

    def _scalar_tbl(self, a, kind: str, scalar: int) -> torch.Tensor:
        """The ``[lvl+1, 1]`` column of ``scalar`` for ``kind`` (``"mul"``:
        Montgomery form mod q, ``"add"``: scalar mod q, ``"sub"``: -scalar
        mod q), cached per (kind, scalar, level)."""
        lvl = self.level_of(a)
        fn = {"mul": lambda q: nt.mform(scalar % q, q), "add": lambda q: scalar % q,
              "sub": lambda q: (q - scalar % q) % q}[kind]
        return self._cached((kind, scalar, lvl), lambda: _tbl(
            [fn(q) for q in self.moduli[: lvl + 1]], (lvl + 1, 1), self.device))

    def mul_scalar_bigint(self, a, scalar: int):
        """a * scalar mod q per limb, arbitrary-precision scalar."""
        q, _, _, qinv = self._qc(a)
        return mk.mred(a, self._scalar_tbl(a, "mul", scalar), q, qinv)

    # the JAX package's mul_scalar has the same body as mul_scalar_bigint
    mul_scalar = mul_scalar_bigint

    def add_scalar_bigint(self, a, scalar: int):
        return mk.add(a, self._scalar_tbl(a, "add", scalar), self._qc(a)[0])

    def sub_scalar_bigint(self, a, scalar: int):
        return mk.add(a, self._scalar_tbl(a, "sub", scalar), self._qc(a)[0])

    add_scalar = add_scalar_bigint
    sub_scalar = sub_scalar_bigint

    # -- remaining coefficient-wise utilities (ring/ring.go:146-801) -------

    def add_nomod(self, a, b):
        return a + b

    def sub_nomod(self, a, b):
        """a + q - b, without the conditional reduction (result < a + q)."""
        return a + self._qc(a)[0] - b

    def mul_coeffs_montgomery_constant(self, a, b):
        """a .* b * 2^-64 mod q, lazily reduced into [0, 2q)."""
        q, _, _, qinv = self._qc(a)
        return mk.mred_constant(a, b, q, qinv)

    def mul_coeffs_montgomery_and_add_nomod(self, a, b, c):
        q, _, _, qinv = self._qc(a)
        return mk.mred_add_lazy(a, b, c, q, qinv)

    def mul_coeffs(self, a, b):
        """Barrett a .* b mod q (no Montgomery precondition)."""
        q, u0, u1, _ = self._qc(a)
        return mk.bred(a, b, q, u0, u1)

    def _const(self, m: int) -> torch.Tensor:
        return self._cached(("const", m), lambda: _tbl([m], (1, 1), self.device))

    def mod_scalar(self, a, m: int):
        """Each coefficient mod an arbitrary 64-bit m (ring/ring.go:146)."""
        return mk.bred_add(a, self._const(m), self._const(nt.bred_params(m)[0]))

    def and_scalar(self, a, m: int):
        return a & self._const(m)

    def or_scalar(self, a, m: int):
        return a | self._const(m)

    def xor_scalar(self, a, m: int):
        return a ^ self._const(m)

    def shift(self, a, n_shift: int):
        """Cyclic left shift of the coefficient slices (ring/ring.go:575)."""
        return torch.roll(a, -n_shift, dims=-1)

    def mul_by_pow2(self, a, pow2: int):
        """a * 2^pow2 mod q (ring/ring.go:629)."""
        return self.mul_scalar(a, 1 << pow2)

    def mult_by_monomial(self, a, degree: int):
        """a(X) * X^degree in the negacyclic ring (ring/ring.go:663-723)."""
        n = self.n
        shift = degree % (n << 1)
        if shift == 0:
            return a
        q = self._qc(a)[0]
        x = a
        if shift >= n:
            x = self.neg(x)
            shift -= n
        if shift == 0:
            return x
        rolled = torch.roll(x, shift, dims=-1)
        # wrapped-around coefficients pick up a sign flip; a zero stays zero
        wrapped = torch.arange(n, device=a.device) < shift
        neg = torch.where(rolled == 0, rolled, q - rolled)
        return torch.where(wrapped, neg, rolled)

    def mul_by_vector_montgomery(self, a, vector):
        """a .* vector (Montgomery per-slot weights) (ring/ring.go:726)."""
        vec = u.from_u64(np.asarray(vector, dtype=np.uint64).reshape(1, -1), a.device)
        q, _, _, qinv = self._qc(a)
        return mk.mred(a, vec, q, qinv)

    def bit_reverse(self, a):
        """Permute coefficients into bit-reversed order (ring/ring.go:749)."""
        idx = self._cached(("brev",), lambda: torch.from_numpy(np.asarray(
            nt.bit_reverse_array(np.arange(self.n, dtype=np.int64), self.log_n),
            dtype=np.int64)).to(self.device))
        return torch.index_select(a, -1, idx)

    def _rotate_rows(self, lvl: int, n_rot: int) -> np.ndarray:
        """psi^(2*n_rot) power table for Galois rotation: gal[j] =
        root^j * 2^64 mod q per limb, built once per (level, rotation) with
        vectorised square-and-multiply on object arrays."""
        def build():
            rows = np.empty((lvl + 1, self.n), dtype=np.uint64)
            exps = np.arange(self.n, dtype=np.uint64)
            for i, q in enumerate(self.moduli[: lvl + 1]):
                psi = nt.inv_mform(self.psi_mont[i], q)
                rb = pow(psi * psi % q, n_rot, q)
                acc = np.full(self.n, nt.mform(1, q), dtype=object)
                for b in range(self.log_n):
                    sel = (exps >> np.uint64(b)) & np.uint64(1) == 1
                    if sel.any():
                        acc[sel] = acc[sel] * rb % q
                    rb = rb * rb % q
                rows[i] = acc.astype(np.uint64)
            return rows

        return self._cached(("rot", lvl, n_rot), build)

    def rotate(self, a, n_rot: int):
        """Galois rotation in NTT form via psi^2 twisting (ring/ring.go:775);
        requires bit-reversed-permuted data before the NTT."""
        lvl = self.level_of(a)
        twist = self._cached(("rotrows", lvl, n_rot),
                             lambda: u.from_u64(self._rotate_rows(lvl, n_rot), self.device))
        q, _, _, qinv = self._qc(a)
        return mk.mred(a, twist, q, qinv)

    def exp(self, a, e: int):
        """a(X)^e in the ring by NTT pointwise powering (the reference's Exp
        at ring/ring.go:441 clobbers its own output with a stray InvNTT;
        this is the corrected semantic, as in the JAX package)."""
        x = self.ntt(a)
        acc = None
        while e > 0:
            if e & 1:
                acc = x if acc is None else self.mul_coeffs(acc, x)
            x = self.mul_coeffs(x, x)
            e >>= 1
        if acc is None:
            return self.set_coeffs_bigint([1] + [0] * (self.n - 1))
        return self.intt(acc)

    def mul_poly(self, a, b):
        """Full negacyclic polynomial product via NTT (ring/ring.go:358)."""
        return self.intt(self.mul_coeffs_montgomery(self.mform(self.ntt(a)), self.ntt(b)))

    def mul_poly_naive(self, a, b):
        """Schoolbook negacyclic convolution on the host with Python ints
        (ring/ring.go:383): the slow exact twin of :meth:`mul_poly`."""
        n = self.n
        av, bv = u.to_u64(a), u.to_u64(b)
        L = av.shape[-2]
        out = np.zeros((L, n), dtype=np.uint64)
        for i in range(L):
            q = self.moduli[i]
            brow = bv[i].astype(object)
            acc = np.zeros(2 * n, dtype=object)
            for j in range(n):
                aj = int(av[i, j])
                if aj:
                    acc[j : j + n] += aj * brow
            out[i] = ((acc[:n] - acc[n:]) % q).astype(np.uint64)
        return u.from_u64(out, a.device)

    def equal(self, a, b) -> bool:
        return bool(torch.equal(self.reduce(a), self.reduce(b)))

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
        """List-of-ints view of :meth:`poly_to_bigint_vec`."""
        return self.poly_to_bigint_vec(x).tolist()

    def poly_to_bigint_vec(self, x: torch.Tensor) -> np.ndarray:
        """CRT reconstruction over the carried limbs
        (ring/ring_context.go:384-421): an object array of Python ints in
        [0, prod(q_i)), built with whole-row big-int ufunc loops."""
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
        return acc % mod
