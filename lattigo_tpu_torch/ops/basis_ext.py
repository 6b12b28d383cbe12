"""RNS basis extension (HPS'18 fast base conversion) and CRT decomposition.

Counterpart of ``lattigo_tpu/ops/basis_ext.py`` (ring/ring_basis_extension.go).
The correction multiple ``v = floor(sum_i y_i / q_i)`` is computed in 58-bit
integer fixed point through per-modulus reciprocal words
``M_i = floor(2^122 / q_i)``, exactly as the JAX package does, so both
packages agree bit for bit (the reference itself uses float64 there).

All functions broadcast over leading dims of ``[..., L, N]`` tensors.

:func:`mod_up` launches ``csrc/mod_up.cu`` for a CUDA tensor (one thread a
coefficient column; no TPU kernel: XLA fuses the JAX function into one
device pass under ``jax.jit``); its plain version :func:`mod_up_plain`
serves CPU tensors.  Bound on the GPU: the operations from ls = 2 on
(``(ls (k + 1) + k)`` Montgomery products a column), else the bytes.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from lattigo_tpu_torch import _build
from lattigo_tpu_torch.ops import modred, modred_kernel as mk, number_theory as nt
from lattigo_tpu_torch.ops import u64 as u
from lattigo_tpu_torch.utils import profiling

_V_FRAC_BITS = 58  # fixed-point fractional bits of the correction term


def _col(vals, device) -> torch.Tensor:
    return u.from_u64(np.array(vals, dtype=np.uint64).reshape(-1, 1), device)


class ModUpParams:
    """Precomputed tables for exact base conversion src -> dst
    (ring/ring_basis_extension.go:76-145)."""

    def __init__(self, src, dst, device):
        self.src = [int(q) for q in src]
        self.dst = [int(p) for p in dst]
        big_q = 1
        for q in self.src:
            big_q *= q

        qib, m_lo, m_hi = [], [], []
        for q in self.src:
            qib.append(nt.mform(pow(big_q // q, -1, q), q))
            m = (1 << (64 + _V_FRAC_BITS)) // q
            m_lo.append(m & nt.MASK64)
            m_hi.append(m >> 64)
        src_rows = [qib, m_lo, m_hi, self.src, [nt.mred_params(q) for q in self.src]]
        # correction: (-Q) mod pj, Montgomery form wrt pj (and plain, for
        # the centered lift's conditional subtraction)
        dst_rows = [self.dst, [nt.mred_params(p) for p in self.dst],
                    [nt.bred_params(p)[0] for p in self.dst],
                    [nt.mform((-big_q) % p, p) for p in self.dst],
                    [(-big_q) % p for p in self.dst]]
        # (Q/qi) mod pj, Montgomery form wrt pj: [ls, ld]
        qispj = np.array([[nt.mform((big_q // q) % p, p) for p in self.dst] for q in self.src],
                         dtype=np.uint64)

        self.qib_mont_, self.m_lo_, self.m_hi_, self.sq_, self.sqinv_ = (
            _col(r, device) for r in src_rows)
        self.dp_, self.dpinv_, self.dp_u0_, self.negq_mont_, self.negq_plain_ = (
            _col(r, device) for r in dst_rows)
        self.qispj_mont_ = u.from_u64(qispj[..., None], device)  # [ls, ld, 1]
        # the kernel's tables in one flat array: [5, ls] source rows, [5, ld]
        # destination rows, then [ls, ld] (csrc/mod_up.cu Args.tab)
        self.packed_ = u.from_u64(np.concatenate([
            np.array(src_rows, dtype=np.uint64).ravel(),
            np.array(dst_rows, dtype=np.uint64).ravel(), qispj.ravel()]), device)
        self._sel: dict = {}

    def sel_vector(self, dst_sel) -> torch.Tensor:
        """The destination limbs ``dst_sel`` selects (all for None) as an
        int32 index vector on the device, cached: the kernel's ``sel``."""
        key = tuple(range(len(self.dst))) if dst_sel is None else tuple(int(j) for j in dst_sel)
        if not all(0 <= j < len(self.dst) for j in key):
            raise IndexError(f"dst_sel {key} out of range for {len(self.dst)} limbs")
        if key not in self._sel:
            self._sel[key] = torch.tensor(key, dtype=torch.int32, device=self.packed_.device)
        return self._sel[key]


_lib = None
# mod_up_launch: x and its [B, ls, N] strides; tables, sel, out; B, N; ls,
# ld, k, centered; the stream
ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 3
            + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("mod_up")
        lib.mod_up_launch.argtypes = ARGTYPES
        lib.mod_up_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _takes_kernel(x: torch.Tensor) -> bool:
    """Whether :func:`mod_up` launches the kernel for ``x``: an int64 CUDA
    tensor (unless ``modred_kernel.FORCE_PLAIN``); a CPU tensor takes the
    plain version; anything else raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda" or x.dtype != torch.int64:
        raise TypeError(f"mod_up takes int64 tensors on cpu or cuda, got {x.dtype} on {x.device}")
    return not mk.FORCE_PLAIN


def _launch(x: torch.Tensor, strides, mp: ModUpParams, sel: torch.Tensor, out: torch.Tensor,
            centered: bool) -> int:
    """Launches the kernel on the current stream of ``out``'s device;
    returns the C entry's error (0: launched)."""
    ls, k, n = x.shape[-2], out.shape[-2], x.shape[-1]
    return mk.launch_on(out.device, lambda stream: _library().mod_up_launch(
        x.data_ptr(), *strides, mp.packed_.data_ptr(), sel.data_ptr(), out.data_ptr(),
        out.numel() // (k * n), n, ls, len(mp.dst), k, int(centered), stream))


def mod_up(x: torch.Tensor, mp: ModUpParams, dst_sel=None, centered: bool = False) -> torch.Tensor:
    """:func:`mod_up_plain` as one launch of ``csrc/mod_up.cu`` for a CUDA
    tensor; the plain version for a CPU tensor."""
    ls = x.shape[-2]
    assert ls == len(mp.src), (ls, len(mp.src))
    if not _takes_kernel(x):
        return mod_up_plain(x, mp, dst_sel, centered)
    return _mod_up_kernel(x, mp, dst_sel, centered)


@profiling.timed("kernel.mod_up")
def _mod_up_kernel(x: torch.Tensor, mp: ModUpParams, dst_sel, centered: bool) -> torch.Tensor:
    """:func:`mod_up`'s launch (its host side is the span ``kernel.mod_up``)."""
    ls = x.shape[-2]
    if x.device != mp.packed_.device:
        raise ValueError(f"x on {x.device}, basis tables on {mp.packed_.device}")
    sel = mp.sel_vector(dst_sel)
    plan = mk.launch_plan((x,))
    out = torch.empty((*x.shape[:-2], len(sel), x.shape[-1]), dtype=torch.int64,
                      device=x.device)
    if out.numel() == 0:
        return out
    err = _launch(plan.operands[0].tensor, plan.operands[0].strides, mp, sel, out, centered)
    if err == -2:
        raise RuntimeError(f"mod_up_launch does not take {ls} -> {len(sel)} limbs "
                           f"over {plan.dims}")
    if err != 0:
        raise RuntimeError(f"mod_up_launch failed with CUDA error {err}")
    mod_up.launches += 1
    mod_up.copies += plan.copies
    if mk._RECORD is not None:
        mk._RECORD.append(("mod_up", ((tuple(x.shape), tuple(x.stride())),),
                           (mp, dst_sel, centered)))
    return out


mod_up.launches = 0  # launches of csrc/mod_up.cu
mod_up.copies = 0  # input copies the launch plans made


def mod_up_plain(x: torch.Tensor, mp: ModUpParams, dst_sel=None,
                 centered: bool = False) -> torch.Tensor:
    """Exact base conversion of ``x`` ([..., ls, N], basis src) to
    [..., len(dst_sel), N] in basis dst (ring/ring_basis_extension.go:352-393).
    ``dst_sel`` selects which destination limbs to produce (default: all).
    No selection or a ``range`` slices the tables and copies nothing from
    the host; any other selection gathers them.

    ``centered=True`` lifts the centered representative instead: the integer
    x - Q*[x >= Q/2] re-expressed mod each p_j, as the JAX package does (the
    reference centers through host big integers, dckks/public_refresh.go:
    102-151).  The fractional part of the fixed-point accumulator is x/Q,
    so its bit F-1 decides the half."""
    ls = x.shape[-2]
    assert ls == len(mp.src), (ls, len(mp.src))
    if dst_sel is None:
        sel = slice(None)
    elif isinstance(dst_sel, range) and dst_sel.step == 1:
        sel = slice(dst_sel.start, dst_sel.stop)
    else:
        sel = list(dst_sel)

    # y_i = x_i * (Q/q_i)^-1 mod q_i
    y = modred.mred(x, mp.qib_mont_, mp.sq_, mp.sqinv_)

    # v = floor(sum_i y_i / q_i) in 58-bit fixed point; the upward slack
    # 2*ls+1 covers the per-term truncation (< 2 units each)
    t = u.mulhi64(y, mp.m_lo_) + y * mp.m_hi_
    vacc = t[..., 0:1, :]
    for i in range(1, ls):
        vacc = vacc + t[..., i : i + 1, :]
    vacc = vacc + (2 * ls + 1)
    v = u.shr(vacc, _V_FRAC_BITS)

    dp, dpinv, dp_u0 = mp.dp_[sel], mp.dpinv_[sel], mp.dp_u0_[sel]
    # acc_j = sum_i y_i * (Q/q_i mod p_j), lazily reduced every 7 adds
    acc = None
    pending = 0
    for i in range(ls):
        term = modred.mred(y[..., i : i + 1, :], mp.qispj_mont_[i, sel], dp, dpinv)
        acc = term if acc is None else acc + term
        pending += 1
        if pending == 7:
            acc = modred.bred_add(acc, dp, dp_u0)
            pending = 1
    corr = modred.mred(v, mp.negq_mont_[sel], dp, dpinv)
    out = modred.bred_add(acc + corr, dp, dp_u0)
    if centered:
        upper = u.shr(vacc, _V_FRAC_BITS - 1) & 1
        out = torch.where(upper == 1, modred.cred(out + mp.negq_plain_[sel], dp), out)
    return out


class FastBasisExtender:
    """Q <-> P extension and ModDown (divide-and-round by P or Q)
    (ring/ring_basis_extension.go:9-348)."""

    def __init__(self, ring_q, ring_p):
        self.ring_q = ring_q
        self.ring_p = ring_p
        dev = ring_q.device
        self.params_qp = ModUpParams(ring_q.moduli, ring_p.moduli, dev)
        self.params_pq = ModUpParams(ring_p.moduli, ring_q.moduli, dev)
        big_p = ring_p.modulus_bigint
        big_q = ring_q.modulus_bigint
        # P^-1 mod q_i (Montgomery), Q^-1 mod p_j (Montgomery)
        self.mod_down_pq_ = _col(
            [nt.mform(pow(big_p % q, -1, q), q) for q in ring_q.moduli], dev
        )
        self.mod_down_qp_ = _col(
            [nt.mform(pow(big_q % p, -1, p), p) for p in ring_p.moduli], dev
        )
        self._qp_lvl: dict[int, ModUpParams] = {}

    def _params_qp(self, lvl_q: int) -> ModUpParams:
        if lvl_q == self.ring_q.L - 1:
            return self.params_qp
        if lvl_q not in self._qp_lvl:
            self._qp_lvl[lvl_q] = ModUpParams(
                self.ring_q.moduli[: lvl_q + 1], self.ring_p.moduli, self.ring_q.device
            )
        return self._qp_lvl[lvl_q]

    def mod_up_qp(self, x_q):
        """Extend [.., lq+1, N] (basis Q levels) to the full P basis."""
        return mod_up(x_q, self._params_qp(self.ring_q.level_of(x_q)))

    def mod_up_pq(self, x_p, lvl_q: int):
        """Extend a full-P-basis poly to Q limbs 0..lvl_q."""
        return mod_up(x_p, self.params_pq, dst_sel=range(lvl_q + 1))

    @staticmethod
    def _div(x_main, pool, inv_mont, ring):
        lvl = ring.level_of(x_main)
        return mk.mred_diff(x_main, pool, inv_mont[: lvl + 1], ring.q_[: lvl + 1],
                            ring.qinv_[: lvl + 1])

    def mod_down_split_pq(self, x_q, x_p):
        """(x - [x]_P) / P in basis Q, coefficient domain
        (ring/ring_basis_extension.go:281-311)."""
        pool = self.mod_up_pq(x_p, self.ring_q.level_of(x_q))
        return self._div(x_q, pool, self.mod_down_pq_, self.ring_q)

    def mod_down_split_ntt_pq(self, x_q, x_p):
        """Same, NTT domain in and out (ring/ring_basis_extension.go:207-245)."""
        lvl = self.ring_q.level_of(x_q)
        pool = self.ring_q.ntt(self.mod_up_pq(self.ring_p.intt(x_p), lvl))
        return self._div(x_q, pool, self.mod_down_pq_, self.ring_q)

    def mod_down_split_qp(self, x_q, x_p):
        """(x - [x]_Q) / Q in basis P (ring/ring_basis_extension.go:314-348)."""
        return self._div(x_p, self.mod_up_qp(x_q), self.mod_down_qp_, self.ring_p)


class Decomposer:
    """Key-switch CRT decomposition D_beta(c) for arbitrary alpha = #P
    (ring/ring_basis_extension.go:398-601)."""

    def __init__(self, q_moduli, p_moduli, device):
        self.device = device
        self.q_moduli = [int(q) for q in q_moduli]
        self.p_moduli = [int(p) for p in p_moduli]
        self.n_q = len(self.q_moduli)
        self.n_p = len(self.p_moduli)
        self.alpha = self.n_p
        self.beta = -(-self.n_q // self.alpha)
        self.xalpha = [self.alpha] * self.beta
        if self.n_q % self.alpha != 0:
            self.xalpha[-1] = self.n_q % self.alpha
        self._params: dict[tuple[int, int, int], ModUpParams] = {}

    def _mod_up_params(self, level: int, beta_idx: int, index: int) -> ModUpParams:
        """The conversion of block ``beta_idx``'s ``index + 2`` source limbs
        to the limbs it produces at ``level``: the Q limbs 0..level outside
        the block, in order, then the P limbs."""
        key = (level, beta_idx, index)
        if key not in self._params:
            start = beta_idx * self.alpha
            nsrc = index + 2
            dst = [q for j, q in enumerate(self.q_moduli[: level + 1])
                   if not start <= j < start + nsrc]
            self._params[key] = ModUpParams(self.q_moduli[start : start + nsrc],
                                            dst + self.p_moduli, self.device)
        return self._params[key]

    def source_range(self, level: int, beta_idx: int) -> tuple[int, int]:
        """(start, count) of the source limbs block ``beta_idx`` reads at
        ``level``: the limbs whose values pass through unmodified."""
        alpha_i = self.xalpha[beta_idx]
        start = beta_idx * self.alpha
        if (start + alpha_i > level + 1 and (level + 1) % self.n_p == 1) or alpha_i == 1:
            return start, 1
        if level >= alpha_i + start:
            return start, alpha_i
        return start, (level - 1) % self.alpha + 2

    def decompose_and_split(self, level: int, beta_idx: int, x):
        """x ([..., level+1, N] basis Q, coefficient domain) -> block
        ``beta_idx`` of the decomposition, returned in basis Q[0..level] and
        basis P (ring/ring_basis_extension.go:601-713)."""
        alpha_i = self.xalpha[beta_idx]
        start = beta_idx * self.alpha
        end = start + alpha_i

        if (end > level + 1 and (level + 1) % self.n_p == 1) or alpha_i == 1:
            # single-limb block: plain replication, no reconstruction
            sl = x[..., start : start + 1, :]
            shape = lambda c: (*sl.shape[:-2], c, sl.shape[-1])
            return sl.expand(shape(level + 1)), sl.expand(shape(self.n_p))

        if level >= alpha_i + start:
            index = alpha_i - 2
        else:
            index = (level - 1) % self.alpha

        nsrc = index + 2
        src = x[..., start : start + nsrc, :]

        # destination limbs: Q limbs outside the block + the P block; limbs
        # inside the block are the source residues themselves
        conv = mod_up(src, self._mod_up_params(level, beta_idx, index))
        n_out_q = conv.shape[-2] - self.n_p
        conv_q, x_p = conv[..., :n_out_q, :], conv[..., n_out_q:, :]

        # reassemble the Q part in limb order
        x_q = torch.cat(
            [conv_q[..., :start, :], src, conv_q[..., start:, :]], dim=-2
        )
        return x_q, x_p
