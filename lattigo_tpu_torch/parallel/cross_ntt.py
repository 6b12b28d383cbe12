"""Cross-rank four-step NTT: one transform split over the ranks of a group.

Counterpart of ``lattigo_tpu/parallel/cross_ntt.py``.  A negacyclic NTT of
dimension N = n1 x n2 runs as (Bailey's four steps over the reference's DIT
schedule, twiddle order per ring/ring_context.go:166-204, so outputs stay
bit-exact):

  1. view the coefficients as an (n1, n2) matrix; this rank takes its
     n2 / D columns: every butterfly stage with stride >= n2 couples rows
     only, so the first log2(n1) stages are local;
  2. ``all_to_all_single`` from columns to rows;
  3. the remaining log2(n2) stages couple within rows, with the stage
     twiddles of this rank's n1 / D rows;
  4. the exact reduction, then an all-gather of the rows.

The inverse runs the mirror schedule: row stages, all-to-all back, column
stages, times N^-1.  The butterflies are ``Ring._ntt_simple``'s, so the
transform equals ``Ring.ntt_limbs`` / ``intt_limbs`` bit for bit.

The JAX function returns a global array that later ops read whole; here
the input is replicated and every rank gets the full transform back (step
4's all-gather).  That is a difference in communication, not in result.
As in the JAX package this is plain tensor code and collectives, no kernel.

``sharded_ntt(group)`` routes every ``Ring`` transform with N >= ``min_n``
through this transform for the duration of the block (``Ring._transform``
asks :func:`active_for`), so scheme code reaches it with no plumbing.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from lattigo_tpu_torch.ops import modred
from lattigo_tpu_torch.ops import u64 as u
from lattigo_tpu_torch.parallel.mesh import gather

# (group, min_n) installed by sharded_ntt(); read by Ring._transform
_ACTIVE: tuple | None = None


@contextlib.contextmanager
def sharded_ntt(group=None, min_n: int = 1 << 14):
    """Route every Ring NTT / InvNTT with N >= ``min_n`` through the
    cross-rank four-step transform over ``group`` (None: the world) for the
    duration of the block.  Every rank of the group must make the same
    transforms in the same order."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = (dist.group.WORLD if group is None else group, min_n)
    try:
        yield
    finally:
        _ACTIVE = prev


def active_for(n: int):
    """The group when a sharded-NTT block covers ring dimension n, else None."""
    if _ACTIVE is not None and n >= _ACTIVE[1]:
        return _ACTIVE[0]
    return None


def _phase_tables(ring, limbs, n1: int, n2: int, inverse: bool):
    """Per-stage twiddles of the V halves (host, uint64).

    Phase A (strides >= n2, row-coupling): [L, n1/2] per stage, one value
    per V row.  Phase B (strides < n2, in-row): [L, n1, n2/2] per stage, one
    value per (row, V column): the part that is split with the rows."""
    n = ring.n
    host = (ring.ntt_psi_inv_host if inverse else ring.ntt_psi_host)[np.array(limbs)]
    a_stages, b_stages = [], []
    t = n // 2
    while t >= 1:
        (a_stages if t >= n2 else b_stages).append(t)
        t //= 2
    if inverse:
        a_stages, b_stages = a_stages[::-1], b_stages[::-1]
    A = []
    for t in a_stages:
        m = n // (2 * t)
        # V row r belongs to group r // (t / n2)
        A.append(host[:, m + np.arange(n1 // 2) // (t // n2)])
    B = []
    for t in b_stages:
        m = n // (2 * t)
        r = np.arange(n1)[:, None]
        cg = np.arange(n2 // 2) // t  # V-column group
        B.append(host[:, m + r * (n2 // (2 * t)) + cg[None, :]])
    return a_stages, A, b_stages, B


def _butterfly_fwd(uu, vv, f, q, two_q, qinv):
    uu = torch.where(u.lt(two_q, uu), uu - two_q, uu)
    vv = modred.mred_constant(vv, f, q, qinv)
    return uu + vv, uu + two_q - vv


def _butterfly_inv(uu, vv, f, q, two_q, qinv):
    x = uu + vv
    x = torch.where(u.lt(two_q, x), x - two_q, x)
    return x, modred.mred_constant(uu + two_q - vv, f, q, qinv)


def _tables(ring, limbs, n2: int, D: int, rank: int, inverse: bool):
    """This rank's device tables, cached in ``ring.kernel_cache`` (not in
    the ring's LRU table cache, so they never evict the evaluator's)."""
    return ring.kernel_table(("four_step", limbs, n2, D, rank, inverse), _build_tables, ring,
                             limbs, n2, D, rank, inverse)


def _build_tables(ring, limbs, n2: int, D: int, rank: int, inverse: bool):
    n1 = ring.n // n2
    rows = slice(rank * (n1 // D), (rank + 1) * (n1 // D))
    a_st, A, b_st, B = _phase_tables(ring, limbs, n1, n2, inverse)
    dev = ring.device
    return (a_st, [u.from_u64(a, dev) for a in A],
            b_st, [u.from_u64(np.ascontiguousarray(b[:, rows]), dev) for b in B])


def _phase_a(x, n2: int, stages, tw, consts, inverse: bool):
    """The row-coupling stages (strides >= n2) on a column shard
    [Bf, L, n1, C]."""
    Bf, L, n1, C = x.shape
    q, two_q, qinv = (c.reshape(1, L, 1, 1, 1) for c in consts)
    bf = _butterfly_inv if inverse else _butterfly_fwd
    for t, f in zip(stages, tw):
        k = t // n2  # V rows per group half
        g = n1 // 2 // k
        xr = x.reshape(Bf, L, g, 2, k, C)
        a, b = bf(xr[:, :, :, 0], xr[:, :, :, 1], f.reshape(1, L, g, k, 1), q, two_q, qinv)
        x = torch.stack([a, b], dim=3).reshape(Bf, L, n1, C)
    return x


def _phase_b(x, stages, tw, consts, inverse: bool):
    """The in-row stages (strides < n2) on a row shard [Bf, L, R, n2], with
    the twiddles of those rows ([L, R, n2/2] a stage)."""
    Bf, L, R, n2 = x.shape
    q, two_q, qinv = (c.reshape(1, L, 1, 1, 1) for c in consts)
    bf = _butterfly_inv if inverse else _butterfly_fwd
    for t, f in zip(stages, tw):
        g = n2 // (2 * t)
        xr = x.reshape(Bf, L, R, g, 2, t)
        a, b = bf(xr[..., 0, :], xr[..., 1, :], f.reshape(1, L, R, g, t), q, two_q, qinv)
        x = torch.stack([a, b], dim=4).reshape(Bf, L, R, n2)
    return x


def ntt_four_step(ring, x: torch.Tensor, group=None, n2: int | None = None,
                  inverse: bool = False, limbs: tuple[int, ...] | None = None) -> torch.Tensor:
    """The negacyclic (inverse) NTT of the replicated ``x`` [..., L, N] over
    the carried limbs (default: the prefix 0..level), split over the ranks
    of ``group`` (None: the world); every rank gets the full transform.
    Equal bit for bit to ``ring.ntt_limbs`` / ``intt_limbs`` (inputs below
    4q; the inverse folds them below 2q first, as ``_intt_simple`` does).

    ``n2`` defaults to the JAX package's max(128, D), or to N / D where that
    leaves fewer than D rows (rings of N < 128 D, which the JAX default
    cannot split)."""
    n = ring.n
    D = dist.get_world_size(group)
    r = dist.get_rank(group)
    n2 = n2 or min(max(128, D), n // D)
    n1 = n // n2
    if n1 * n2 != n or n1 % D or n2 % D:
        raise ValueError(f"n1 = {n1} and n2 = {n2} must split over {D} ranks")
    limbs = tuple(range(ring.level_of(x) + 1)) if limbs is None else tuple(limbs)
    L = len(limbs)
    batch = x.shape[:-2]
    Bf = int(np.prod(batch, dtype=np.int64)) if batch else 1
    R, C = n1 // D, n2 // D  # this rank's rows (phase B) and columns (phase A)
    a_st, A, b_st, B = _tables(ring, limbs, n2, D, r, inverse)
    consts = [ring._tbl_rows(t, limbs) for t in (ring.q_, ring.two_q_, ring.qinv_)]
    q = consts[0].reshape(1, L, 1, 1)
    X = x.reshape(Bf, L, n1, n2)
    if not inverse:
        cols = _phase_a(X[..., r * C : (r + 1) * C].contiguous(), n2, a_st, A, consts, False)
        # columns -> rows: block j of the send buffer holds rank j's rows
        send = cols.reshape(Bf, L, D, R, C).permute(2, 0, 1, 3, 4).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        rows = recv.permute(1, 2, 3, 0, 4).reshape(Bf, L, R, n2)
        rows = _phase_b(rows, b_st, B, consts, False)
        rows = modred.bred_add(rows, q, ring._tbl_rows(ring.u0_, limbs).reshape(1, L, 1, 1))
        out = torch.cat(gather(rows, group), dim=2)
    else:
        two_q = consts[1].reshape(1, L, 1, 1)
        rows = X[:, :, r * R : (r + 1) * R].contiguous()
        for _ in range(2):  # inputs below 4q folded below 2q
            rows = torch.where(u.lt(two_q, rows), rows - two_q, rows)
        rows = _phase_b(rows, b_st, B, consts, True)
        # rows -> columns: block j of the send buffer holds rank j's columns
        send = rows.reshape(Bf, L, R, D, C).permute(3, 0, 1, 2, 4).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        cols = recv.permute(1, 2, 0, 3, 4).reshape(Bf, L, n1, C)
        cols = _phase_a(cols, n2, a_st, A, consts, True)
        n_inv = ring._tbl_rows(ring.n_inv_, limbs).reshape(1, L, 1, 1)
        cols = modred.mred(cols, n_inv, q, consts[2].reshape(1, L, 1, 1))
        out = torch.cat(gather(cols, group), dim=3)
    return out.reshape(*batch, L, n)
