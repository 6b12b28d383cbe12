"""Encrypted matrix-vector products: an m x n real matrix times a ciphertext
of n = N/2 slots, by GAZELLE's hybrid diagonal method (Juvekar,
Vaikuntanathan and Chandrakasan, USENIX Security 2018) with Halevi and
Shoup's baby-step giant-step and hoisting ("Faster Homomorphic Linear
Transformations in HElib", CRYPTO 2018).

Lattigo v1.3.1 has no linear-transform routine; its users compose one from
``RotateHoisted`` (ckks/evaluator.go:1252-1392), ``RotateColumns``,
``MulRelin`` with a plaintext, ``Add`` and ``Rescale``, and so does this
module, on the plain ``Evaluator``.

The method: the m extended diagonals ``diag_k[i] = W[i mod m][(i + k) mod n]``
(m divides n) give ``z = sum_k diag_k * rot_k(x)``, whose slots
``r, r + m, r + 2m, ...`` sum to ``(W x)[r]``; log2(n / m) rotate-and-add
steps by n/2, n/4, ..., m then leave ``W x`` in every block of m slots.
With k = n1 j + i (i < n1 baby steps, j < n2 = m / n1 giant steps),

    z = sum_j rot_(n1 j)( sum_i rot_(-n1 j)(diag_(n1 j + i)) * rot_i(x) ),

so the n1 - 1 baby rotations share one decomposition
(``Evaluator.rotate_hoisted``), each giant rotation and each fold step is
one ``rotate_columns``, and the diagonals are rotated right by n1 j once,
when they are encoded (:func:`encode_diagonals`).

The inner sums are one launch of the key switch's fold
(``ops/key_switch.inner_product``, ``csrc/key_switch.cu``): the baby stack
takes the place of the key's two halves, the diagonals that of the digits,
so that each giant step's n1 plaintext products of both halves are summed
with the fold's lazy reduction and no product goes through memory.  The
diagonals are held in Montgomery form for it.  The result has the scale of
the ciphertext times that of the diagonals, and one ``rescale`` ends the
layer.

Recorder (``utils/profiling.py``), counted while the layer runs in Python,
so that a captured program counts its capture's once a replay:
``ckks.rotations`` (one a key switch with a Galois element),
``ckks.decompositions`` (one a decomposition of c1 the layer issues) and
``ckks.linear.pt_products`` (one a diagonal times a ciphertext); the spans
``ckks.linear.baby``, ``ckks.linear.inner``, ``ckks.linear.giant`` and
``ckks.linear.fold``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lattigo_tpu_torch.models.ckks.elements import Ciphertext
from lattigo_tpu_torch.models.ckks.encoder import Encoder
from lattigo_tpu_torch.ops import key_switch
from lattigo_tpu_torch.utils import profiling


@dataclasses.dataclass
class Diagonals:
    """A matrix's extended diagonals as the layer reads them: ``value``
    [n2, n1, L, N], diagonal n1 j + i rotated right by n1 j at [j, i],
    NTT domain, Montgomery form; ``scale`` the scale they are encoded at."""

    value: torch.Tensor
    scale: float


def rotations(m: int, n1: int, n: int) -> tuple[list[int], list[int], list[int]]:
    """The left rotations of an m-row layer over n slots with n1 baby steps:
    the baby steps 1..n1-1, the giant steps n1 j for 0 < j < m / n1, and
    the fold steps n/2, n/4, ..., m."""
    if n1 < 1 or m % n1 or n % m or m & (m - 1) or n & (n - 1):
        raise ValueError(f"no hybrid layer of {m} rows over {n} slots with {n1} baby steps")
    fold, step = [], n >> 1
    while step >= m:
        fold.append(step)
        step >>= 1
    return list(range(1, n1)), [n1 * j for j in range(1, m // n1)], fold


def pre_rotated(w: np.ndarray, n1: int, j: int) -> np.ndarray:
    """Diagonals n1 j .. n1 j + n1 - 1 of ``w`` [m, n], each rotated right by
    n1 j: row i, slot t holds ``w[(t - n1 j) mod m][(t + i) mod n]``."""
    m, n = w.shape
    t = np.arange(n)
    return w[((t - n1 * j) % m)[None, :], (t[None, :] + np.arange(n1)[:, None]) % n]


def encode_diagonals(params, w: np.ndarray, n1: int, device=None) -> Diagonals:
    """The diagonals of the real matrix ``w`` [m, n] (n the slots, N/2) for
    :func:`mul_matrix_hybrid` with ``n1`` baby steps: ``Encoder.encode``
    at the set's scale and top level, one batch a giant step, then
    Montgomery form."""
    enc = Encoder(params, device)
    ring = enc.ctx.ring_q
    w = np.asarray(w, dtype=np.float64)
    m, n = w.shape
    if n != enc.ctx.max_slots:
        raise ValueError(f"a {m} x {n} matrix over {enc.ctx.max_slots} slots")
    rotations(m, n1, n)
    out = torch.empty((m // n1, n1, enc.params.max_level + 1, enc.ctx.n), dtype=torch.int64,
                      device=enc.ctx.device)
    for j in range(m // n1):
        out[j] = ring.mform(enc.encode(pre_rotated(w, n1, j)).value)
    return Diagonals(out, enc.params.scale)


def _rotated(n: int = 1, decompositions: int = 1) -> None:
    profiling.count("ckks.rotations", n)
    profiling.count("ckks.decompositions", decompositions)


def mul_matrix_hybrid(ev, ct: Ciphertext, diags: Diagonals, rot_keys) -> Ciphertext:
    """``W x`` in every block of m slots of the result, for the ciphertext
    ``ct`` of x, the diagonals ``diags`` of the m-row matrix W
    (:func:`encode_diagonals`; the second dim of ``diags.value`` is the
    number n1 of baby steps) and ``rot_keys``, which holds the left
    rotation key of each of :func:`rotations`; at the scale ``ct.scale *
    diags.scale`` rescaled, one level down where the rescale rule takes
    one."""
    n2, n1 = diags.value.shape[:2]
    slots = ev.ctx.n >> 1
    baby, giant, fold = rotations(n1 * n2, n1, slots)
    missing = [k for k in baby + giant + fold if k not in rot_keys.left]
    if missing:
        raise ValueError(f"missing rotation keys {missing}")
    lvl = ct.level
    if diags.value.shape[2] <= lvl:
        raise ValueError(f"diagonals of {diags.value.shape[2]} limbs for a ciphertext at "
                         f"level {lvl}")

    with profiling.span("ckks.linear.baby"):
        _rotated(len(baby))
        rot = ev.rotate_hoisted(ct, [0] + baby, rot_keys)
        halves = [torch.stack([rot[i].value[h] for i in range(n1)]) for h in (0, 1)]
        del rot
    with profiling.span("ckks.linear.inner"):
        profiling.count("ckks.linear.pt_products", n1 * n2)
        inner = key_switch.inner_product(diags.value[..., : lvl + 1, :], halves[0], halves[1],
                                         ev.ctx.ring_q, tuple(range(lvl + 1)), n1)
        del halves
    scale = ct.scale * diags.scale
    with profiling.span("ckks.linear.giant"):
        out = Ciphertext([inner[0, 0], inner[1, 0]], scale)
        for j, k in enumerate(giant, 1):
            _rotated()
            out = ev.add(out, ev.rotate_columns(Ciphertext([inner[0, j], inner[1, j]], scale), k,
                                                rot_keys))
    with profiling.span("ckks.linear.fold"):
        for k in fold:
            _rotated()
            out = ev.add(out, ev.rotate_columns(out, k, rot_keys))
    return ev.rescale(out)
