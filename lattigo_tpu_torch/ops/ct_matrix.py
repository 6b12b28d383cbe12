"""A plaintext matrix of scalars times a stack of ciphertexts,

    out[h, j] = sum_k w[j, k] x_h[k] + (h == 0) b[j]   (mod q_l, every limb l),

the two polynomials of each output ciphertext j from those of the inputs
x_0, x_1 ``[K, L, N]`` (``csrc/ct_matrix.cu``: one launch a layer).
Lattigo writes this as a loop of ``MultByConstAndAdd``
(ckks/evaluator.go:446), one call a nonzero weight.

:class:`Tables` holds one layer's integer weights at one set of moduli as
the kernel reads them: the taps grouped into tiles of up to
:data:`MAX_TILE` outputs that read the same inputs (a dense layer's
outputs; the maps of a convolution at one position), each tile's columns
and weights in one flat list, and the per-limb constants.  Build it once,
outside any captured program: it copies from the host.

:func:`ct_matrix_plain` follows the kernel's arithmetic on PyTorch tensors:
exact 128-bit sums of the products, folded below q every ``fold``
products.  The words are the canonical residues, so any exact schedule
gives them; a CPU tensor takes it.

Bound on the GPU: the larger of the bytes (x read once, the outputs
written once, the weights) and the products' operations
(``fhe_bench/ct_matrix_roofline.py``).  Which calls launch, and the launch
itself, are ``_build``'s, as for the other modular kernels.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lattigo_tpu_torch import _build
from lattigo_tpu_torch.ops import modred
from lattigo_tpu_torch.ops import u64 as u
from lattigo_tpu_torch.utils import profiling

T = torch.Tensor
MAX_TILE = 8  # outputs a tile holds (csrc/ct_matrix.cu MAX_TILE)
TABLE = 3 + MAX_TILE  # words of a tile's row: first tap, taps, outputs, the outputs' indices
MAX_FOLD = 1 << 30


def fold_of(moduli) -> int:
    """Products summed in 128 bits before a fold: the most for which
    ``fold (q - 1)^2 + q`` stays below 2^128 at every modulus."""
    q = max(moduli)
    return max(1, min(MAX_FOLD, ((1 << 128) - q) // (q - 1) ** 2))


@dataclasses.dataclass
class Tables:
    """One layer at the moduli of its limbs, as the kernel reads it (see
    the module's docstring): ``w`` [L, P, MAX_TILE] and ``bias`` [J, L]
    residues (``bias`` None: none), ``col`` int32 [P], ``tiles`` int64
    [tiles, TABLE], ``consts`` [L, 4] (q, u0, 2^64 mod q, its Shoup word);
    ``n_in`` and ``n_out`` the matrix's shape, ``tile`` the kernel's tile
    (the smallest power of two that holds every tile's outputs), ``fold``
    as :func:`fold_of`, ``products`` the nonzero taps."""

    w: T
    col: T
    tiles: T
    bias: T | None
    consts: T
    n_in: int
    n_out: int
    tile: int
    fold: int
    products: int

    @property
    def limbs(self) -> int:
        return self.consts.shape[0]


def tiles_of(rows: np.ndarray, cols: np.ndarray, n_out: int) -> list[tuple[np.ndarray, list]]:
    """The taps (``rows[i]`` the output, ``cols[i]`` the input of tap i) in
    tiles: outputs whose sorted inputs are the same, in order of their
    first output, up to :data:`MAX_TILE` a tile.  Each tile is ``(inputs,
    [(output, tap indices in the order of inputs), ...])``; an output with
    no tap has a tile of no inputs."""
    order = np.lexsort((cols, rows))
    rs, cs = rows[order], cols[order]
    if len(rs) and ((rs[1:] == rs[:-1]) & (cs[1:] == cs[:-1])).any():
        raise ValueError("a tap is given twice")
    bounds = np.searchsorted(rs, np.arange(n_out + 1))
    groups: dict[tuple, list] = {}
    for j in range(n_out):
        a, b = bounds[j], bounds[j + 1]
        groups.setdefault(tuple(cs[a:b].tolist()), []).append((j, order[a:b]))
    out = []
    for inputs, members in groups.items():
        for i in range(0, len(members), MAX_TILE):
            out.append((np.array(inputs, dtype=np.int64), members[i : i + MAX_TILE]))
    return out


def tables(rows, cols, residues: np.ndarray, bias: np.ndarray | None, moduli, n_in: int,
           n_out: int, device) -> Tables:
    """:class:`Tables` of the layer whose tap i (output ``rows[i]``, input
    ``cols[i]``) has the weight residues ``residues[:, i]`` (uint64 [L,
    taps], below each of ``moduli``), with ``bias`` [L, n_out] residues or
    None."""
    rows, cols = np.asarray(rows, dtype=np.int64), np.asarray(cols, dtype=np.int64)
    residues = np.asarray(residues, dtype=np.uint64)
    L = len(moduli)
    if rows.shape != cols.shape or residues.shape != (L, len(rows)):
        raise ValueError(f"{len(rows)} rows, {len(cols)} columns and residues "
                         f"{residues.shape} for {L} limbs")
    if len(rows) and (rows.min() < 0 or rows.max() >= n_out or cols.min() < 0
                      or cols.max() >= n_in):
        raise ValueError(f"a tap outside the {n_out} x {n_in} matrix")
    tiles = tiles_of(rows, cols, n_out)
    n_taps = sum(len(inputs) for inputs, _ in tiles)
    w = np.zeros((L, n_taps, MAX_TILE), dtype=np.uint64)
    col = np.empty(n_taps, dtype=np.int32)
    table = np.full((len(tiles), TABLE), -1, dtype=np.int64)
    p = 0
    for t, (inputs, members) in enumerate(tiles):
        table[t, :3] = (p, len(inputs), len(members))
        col[p : p + len(inputs)] = inputs
        for o, (j, taps) in enumerate(members):
            table[t, 3 + o] = j
            w[:, p : p + len(inputs), o] = residues[:, taps]
        p += len(inputs)
    consts = np.empty((L, 4), dtype=object)
    for i, q in enumerate(moduli):
        r64 = (1 << 64) % q
        consts[i] = (q, ((1 << 128) // q) >> 64, r64, (r64 << 64) // q)
    return Tables(
        u.from_u64(w, device), torch.from_numpy(col).to(device), torch.from_numpy(table).to(device),
        None if bias is None else u.from_u64(np.asarray(bias, dtype=np.uint64).T, device),
        u.from_u64(consts.astype(np.uint64), device), n_in, n_out,
        1 << (max(len(m) for _, m in tiles) - 1).bit_length(), fold_of(moduli), len(rows))


def _reduce128(lo: T, hi: T, q: T, u0: T, r64: T, r64s: T) -> T:
    """(hi 2^64 + lo) mod q (``csrc/ct_matrix.cu`` reduce128)."""
    s = modred.mul_shoup(hi, r64, r64s, q) + modred.bred_add(lo, q, u0)
    s = torch.where(u.ge(s, 2 * q), s - 2 * q, s)
    return modred.cred(s, q)


def ct_matrix_plain(x0: T, x1: T, tab: Tables) -> T:
    """The layer on the stack (x0, x1) ``[K, L, N]``: ``[2, J, L, N]``, by
    the kernel's arithmetic, every tile at once, one tap a step."""
    x = torch.stack((x0, x1))  # [2, K, L, N]
    c = [tab.consts[:, i, None] for i in range(4)]  # each [L, 1]
    tiles = tab.tiles.cpu().numpy()
    n_tiles, most = len(tiles), int(tiles[:, 1].max())
    lo = torch.zeros((2, n_tiles, MAX_TILE, *x.shape[2:]), dtype=torch.int64, device=x.device)
    hi = torch.zeros_like(lo)
    for i in range(most):
        has = tiles[:, 1] > i  # tiles with a tap i
        p = torch.from_numpy(np.where(has, tiles[:, 0] + i, 0)).to(x.device)
        xi = x[:, tab.col[p].long()]  # [2, tiles, L, N]
        wi = tab.w[:, p].permute(1, 2, 0)[..., None]  # [tiles, MAX_TILE, L, 1]
        wi = wi * torch.from_numpy(has).to(x.device)[:, None, None, None]
        plo, phi = u.mul64_128(xi[:, :, None], wi)
        lo, carry = u.add_carry(lo, plo)
        hi = hi + phi + carry
        if (i + 1) % tab.fold == 0:
            lo, hi = _reduce128(lo, hi, *c), torch.zeros_like(hi)
    v = _reduce128(lo, hi, *c)  # [2, tiles, MAX_TILE, L, N]
    out = torch.empty((2, tab.n_out, *x.shape[2:]), dtype=torch.int64, device=x.device)
    for t, row in enumerate(tiles):
        j = torch.from_numpy(row[3 : 3 + row[2]]).to(x.device)
        out[:, j] = v[:, t, : row[2]]
    if tab.bias is not None:
        out[0] = modred.cred(out[0] + tab.bias[..., None], c[0])
    return out


def ct_matrix(x0: T, x1: T, tab: Tables) -> T:
    """:func:`ct_matrix_plain` as one launch of ``csrc/ct_matrix.cu`` for
    CUDA tensors; the plain version for CPU tensors.  x0 and x1 are the
    stack's polynomials ``[K, L, N]``, their words below each limb's
    modulus, at the limbs of ``tab``."""
    if x0.shape != x1.shape or x0.ndim != 3 or x0.shape[0] != tab.n_in \
            or x0.shape[1] != tab.limbs:
        raise ValueError(f"a stack {tuple(x0.shape)} / {tuple(x1.shape)} for a "
                         f"{tab.n_out} x {tab.n_in} layer at {tab.limbs} limbs")
    operands = (x0, x1, tab.w, tab.tiles, tab.consts)
    if not _build.takes_kernel("ct_matrix", *operands):
        return ct_matrix_plain(x0, x1, tab)
    return _ct_matrix_kernel(x0, x1, tab)


@profiling.timed("kernel.ct_matrix")
def _ct_matrix_kernel(x0: T, x1: T, tab: Tables) -> T:
    """:func:`ct_matrix`'s launch (its host side is the span
    ``kernel.ct_matrix``)."""
    copies = 0
    if x0.stride() != x1.stride():
        x0, x1 = x0.contiguous(), x1.contiguous()
        copies = 2
    _, limbs, n = x0.shape
    out = torch.empty((2, tab.n_out, limbs, n), dtype=torch.int64, device=x0.device)
    xstr = np.array(x0.stride(), dtype=np.int64)
    _build.launch("ct_matrix", x0.device, (
        x0.data_ptr(), x1.data_ptr(), xstr.ctypes.data, tab.w.data_ptr(), tab.col.data_ptr(),
        tab.tiles.data_ptr(), None if tab.bias is None else tab.bias.data_ptr(),
        tab.consts.data_ptr(), out.data_ptr(), tab.tiles.shape[0], tab.w.shape[1], tab.n_out, n,
        limbs, tab.tile, tab.fold,
    ), lambda: f"a {tab.n_out} x {tab.n_in} layer on {tuple(x0.shape)}", copies=copies,
        record=("ct_matrix", (x0, x1), (tab,)))
    return out
