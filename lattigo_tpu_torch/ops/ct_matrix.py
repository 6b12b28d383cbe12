"""A plaintext matrix of scalars times a stack of ciphertexts,

    out[h, j] = sum_k w[j, k] x_h[k] + (h == 0) b[j]   (mod q_l, every limb l),

the two polynomials of each output ciphertext j from those of the inputs
x_0, x_1 ``[K, L, N]`` (``csrc/ct_matrix.cu``: one launch a layer).
Lattigo writes this as a loop of ``MultByConstAndAdd``
(ckks/evaluator.go:446), one call a nonzero weight.

The kernel forms the products on the int8 tensor cores (``mma.sync``
m16n8k32, u8 x s8 -> s32) as exact products of byte digits: each x word
as its ``ceil(bits(q) / 8)`` bytes, each weight as ``digits`` balanced s8
digits of its centered residue (the signed integer round(w Delta)
wherever that is below q / 2; 5, 4 and 5 digits at the CryptoNets
layers), each byte-digit pair (a, d) summed in the s32 plane a + d: the
yardstick's ``digits x bytes`` byte products a product, where the 8 x 8
Toeplitz layout of ``csrc/ntt_fourstep.cu`` would form about 4 times as
many.  The planes are recombined into the residue mod q (five planes to
an int64, then Shoup products by 2^(40k) mod q) at the end of a tile's
taps and every ``plane_fold`` k-steps of 32 taps before any plane could
pass :data:`PLANE_BOUND`.  The rows of a product are 8 coefficients of
both polynomials, its columns the up to 8 outputs of a tile; each lane
gathers its x words of a step and splits them into byte planes in
registers, once for the one or two tiles its warp computes.

:class:`Tables` holds one layer's integer weights at one set of moduli as
the kernel reads them: the taps grouped into tiles of up to
:data:`MAX_TILE` outputs that read the same inputs (a dense layer's
outputs; the maps of a convolution at one position), tiles with the same
inputs into groups and slabs, each tile's columns padded to whole steps
of 32 taps, the weights' digits in the mma's B fragment order, and the
per-limb constants.  The launch plan (tiles a slab, tiles a warp,
coefficients a block) comes from the layer's groups and widths
(:func:`plan_of`), the digit counts from the moduli and the weights'
widths.  Build it once, outside any captured program: it copies from the
host.

:func:`ct_matrix_plain` computes the same words on PyTorch tensors with
exact 128-bit sums of the products, folded below q every ``fold``
products, the weights read back from their digits (:func:`weights`).
The words are the canonical residues, so any exact schedule gives them;
a CPU tensor takes it.

Bound on the H100 (``fhe_bench/ct_matrix_roofline.py``): the larger of
the bytes (x read once, the outputs written once, the weights) and the
byte products at the int8 peak: the bytes at each layer of the CryptoNets
cell.  The kernel answers the operations with the tensor cores and the
bytes by reading x from device memory about once, its other reads L1 and
L2 hits; what holds it above its bound is the work around the products
(the gather, the byte split, each output's recombination).
Which calls launch, and the launch itself, are ``_build``'s, as for the
other modular kernels.
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
TABLE = 4 + MAX_TILE  # a tile's row: first tap, taps, outputs, first k-step, the outputs
KSTEP = 32  # taps of one tensor-core product
MAX_FOLD = 1 << 30
PLANE_STEP = 128 * 255  # the most one digit pair adds to a plane a tap
PLANE_BOUND = ((1 << 62) - 1) // 0x0101010101  # planes recombined 5 at a time stay in an int64


def fold_of(moduli) -> int:
    """Products summed in 128 bits before a fold (the plain version): the
    most for which ``fold (q - 1)^2 + q`` stays below 2^128 at every
    modulus."""
    q = max(moduli)
    return max(1, min(MAX_FOLD, ((1 << 128) - q) // (q - 1) ** 2))


def digits_of(lo: int, hi: int) -> int:
    """The fewest balanced s8 digits (each in [-128, 127]) that hold every
    integer in [lo, hi]."""
    for d in range(1, 9):
        ones = ((1 << 8 * d) - 1) // 255  # 0x0101..01
        if -128 * ones <= lo and hi <= 127 * ones:
            return d
    raise ValueError(f"weights in [{lo}, {hi}] need more than 8 digits")


def plane_fold_of(digits: int, nbytes: int) -> int:
    """k-steps of 32 taps summed in the s32 planes before a fold: the most
    for which no plane can pass :data:`PLANE_BOUND` in size (5 planes of
    8 bits apart then make an int64 below 2^62), a tap adding at most
    ``128 * 255 * min(digits, nbytes)`` (a fold leaves a residue's bytes in
    the planes, at most 255 each, on the positive side, which the products'
    127 * 255 never reach)."""
    return max(1, PLANE_BOUND // (KSTEP * PLANE_STEP * min(digits, nbytes)))


@dataclasses.dataclass
class Tables:
    """One layer at the moduli of its limbs, as the kernel reads it (see
    the module's docstring): ``wd`` int8 [L, k-steps, digits, 32, 8] (the
    weights' digits, each lane's B fragment of each k-step), ``slabs``
    int64 [slabs, 4] (first tap, taps, first tile, tiles), ``col`` int32
    [P], ``tiles`` int64 [tiles, TABLE], ``consts`` [L, 10] (q, u0, then
    2^64, 2^40 and 2^80 mod q each with its Shoup word, minus the plane
    groups' offsets mod q, the words' bytes);
    ``bias`` [J, L] residues (None: none); ``n_in`` and ``n_out`` the matrix's shape; ``digits`` the
    weights' digits, ``nbytes`` the most bytes of a limb's words; ``tb``
    tiles a slab, ``tpw`` tiles a warp and ``ss`` strips of 8 coefficients
    a block (:func:`plan_of`); ``plane_fold``
    as :func:`plane_fold_of`, ``fold`` as :func:`fold_of` (the plain
    version's), ``products`` the nonzero taps."""

    wd: T
    slabs: T
    col: T
    tiles: T
    bias: T | None
    consts: T
    n_in: int
    n_out: int
    digits: int
    nbytes: int
    tb: int
    tpw: int
    ss: int
    plane_fold: int
    fold: int
    products: int

    @property
    def limbs(self) -> int:
        return self.consts.shape[0]


def tiles_of(rows: np.ndarray, cols: np.ndarray, n_out: int) -> list[tuple[np.ndarray, list]]:
    """The taps (``rows[i]`` the output, ``cols[i]`` the input of tap i) in
    groups of outputs whose sorted inputs are the same, in order of their
    first output, each cut into tiles of up to :data:`MAX_TILE`.  Each
    group is ``(inputs, tiles)``, a tile ``[(output, tap indices in the
    order of inputs), ...]``; an output with no tap is in a group of no
    inputs."""
    order = np.lexsort((cols, rows))
    rs, cs = rows[order], cols[order]
    if len(rs) and ((rs[1:] == rs[:-1]) & (cs[1:] == cs[:-1])).any():
        raise ValueError("a tap is given twice")
    bounds = np.searchsorted(rs, np.arange(n_out + 1))
    groups: dict[tuple, list] = {}
    for j in range(n_out):
        a, b = bounds[j], bounds[j + 1]
        groups.setdefault(tuple(cs[a:b].tolist()), []).append((j, order[a:b]))
    return [(np.array(inputs, dtype=np.int64),
             [members[i : i + MAX_TILE] for i in range(0, len(members), MAX_TILE)])
            for inputs, members in groups.items()]


def plan_of(tiles_per_group: list[int], digits: int, nbytes: int) -> tuple[int, int, int]:
    """``(tb, tpw, ss)``: tiles a slab, the fewest slabs to a group; tiles a
    warp (two, sharing the warp's words and byte planes, where a group has
    two and the accumulators fit: 5 digits and 6 bytes at most); strips of
    8 coefficients a block, so that a block has 4 to 8 warps."""
    most = max(tiles_per_group)
    tpw = 2 if most > 1 and digits <= 5 and nbytes <= 6 else 1
    tb = -(-most // -(-most // (8 * tpw)))
    return tb, tpw, max(1, 4 // -(-tb // tpw))


def run_of(tab: Tables, n: int) -> int:
    """Slabs a block walks at degree ``n``: every slab of the layer, unless
    that leaves fewer than 1056 blocks (8 a multiprocessor)."""
    blocks = -(-n // (8 * tab.ss)) * tab.limbs
    slabs = tab.slabs.shape[0]
    return slabs if blocks >= 1056 else -(-slabs // -(-1056 // blocks))


def _fragments(wc: np.ndarray, digits: int) -> np.ndarray:
    """``wc`` int64 [L, k-steps * 32, MAX_TILE] (centered weights, each
    k-step's 32 taps by output) as int8 [L, k-steps, digits, 32, 8]: lane
    4 g + t holds output g's digit at taps 4t .. 4t + 3, then 16 + 4t ..
    (the B fragment of mma m16n8k32)."""
    L, rows, _ = wc.shape
    ones = np.uint64(((1 << 8 * digits) - 1) // 255)
    biased = wc.astype(np.uint64) + np.uint64(128) * ones  # below 256^digits
    dig = np.stack([(biased >> np.uint64(8 * a) & np.uint64(0xFF)).astype(np.int16) - 128
                    for a in range(digits)], axis=-1)  # [L, rows, 8, digits]
    dig = dig.reshape(L, rows // KSTEP, 2, 4, 4, MAX_TILE, digits)  # tap = 16 h + 4 t + i
    return np.ascontiguousarray(dig.transpose(0, 1, 6, 5, 3, 2, 4)).astype(np.int8)


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
    if n_in < 1:
        raise ValueError("a layer of no inputs")
    groups = tiles_of(rows, cols, n_out)
    n_tiles = sum(len(members) for _, members in groups)
    steps = [max(1, -(-len(inputs) // KSTEP)) for inputs, _ in groups]  # a tile's k-steps
    n_taps = KSTEP * sum(st * len(members) for st, (_, members) in zip(steps, groups))
    w = np.zeros((L, n_taps, MAX_TILE), dtype=np.uint64)
    col = np.empty(n_taps, dtype=np.int32)
    table = np.full((n_tiles, TABLE), -1, dtype=np.int64)
    groups_at = []  # (first tap, taps, steps, first tile, tiles) of each group
    p = t = 0
    for st, (inputs, members) in zip(steps, groups):
        groups_at.append((p, len(inputs), st, t, len(members)))
        for tile in members:
            table[t, :4] = (p, len(inputs), len(tile), p // KSTEP)
            col[p : p + st * KSTEP] = inputs[-1] if len(inputs) else 0  # padding: a real input
            col[p : p + len(inputs)] = inputs
            for o, (j, taps) in enumerate(tile):
                table[t, 4 + o] = j
                w[:, p : p + len(inputs), o] = residues[:, taps]
            p += st * KSTEP
            t += 1
    q = np.array(moduli, dtype=np.uint64)[:, None, None]
    wc = np.where(w > (q - np.uint64(1)) // np.uint64(2), w.astype(np.int64) - q.astype(np.int64),
                  w.astype(np.int64))
    digits = digits_of(int(wc.min(initial=0)), int(wc.max(initial=0)))
    nbytes = [-(-int(q_).bit_length() // 8) for q_ in moduli]
    tb, tpw, ss = plan_of([len(members) for _, members in groups], digits, max(nbytes))
    slabs = [(p0 + i * KSTEP * st, taps, t0 + i, min(tb, tiles - i))
             for p0, taps, st, t0, tiles in groups_at for i in range(0, tiles, tb)]
    planes = digits + (6 if max(nbytes) <= 6 else 8) - 1  # the kernel's, recombined 5 at a time
    offsets = sum((1 << 62) * (1 << 40 * k) for k in range(-(-planes // 5)))
    consts = np.empty((L, 10), dtype=object)
    for i, q_ in enumerate(moduli):
        r64, r40, r80 = ((1 << b) % q_ for b in (64, 40, 80))
        consts[i] = (q_, ((1 << 128) // q_) >> 64, r64, (r64 << 64) // q_, r40, (r40 << 64) // q_,
                     r80, (r80 << 64) // q_, -offsets % q_, nbytes[i])
    return Tables(
        torch.from_numpy(_fragments(wc, digits)).to(device),
        torch.tensor(slabs, dtype=torch.int64, device=device).reshape(-1, 4),
        torch.from_numpy(col).to(device), torch.from_numpy(table).to(device),
        None if bias is None else u.from_u64(np.asarray(bias, dtype=np.uint64).T, device),
        u.from_u64(consts.astype(np.uint64), device), n_in, n_out, digits, max(nbytes), tb, tpw,
        ss, plane_fold_of(digits, max(nbytes)), fold_of(moduli), len(rows))


def _reduce128(lo: T, hi: T, q: T, u0: T, r64: T, r64s: T) -> T:
    """(hi 2^64 + lo) mod q (``csrc/ct_matrix.cu`` reduce128)."""
    s = modred.mul_shoup(hi, r64, r64s, q) + modred.bred_add(lo, q, u0)
    s = torch.where(u.ge(s, 2 * q), s - 2 * q, s)
    return modred.cred(s, q)


def weights(tab: Tables) -> T:
    """The weights' residues ``[L, P, MAX_TILE]`` (tap p of the tiles'
    columns, output o of its tile), from their digits: each centered
    residue is the digits' sum sum_a d_a 256^a (Horner's rule, every
    partial sum in int64), taken mod q."""
    d = tab.wd.to(torch.int64)  # [L, k-steps, digits, 32 lanes, 8 bytes]
    L, steps, digits = d.shape[:3]
    d = d.reshape(L, steps, digits, MAX_TILE, 4, 2, 4).permute(0, 1, 5, 4, 6, 3, 2)
    d = d.reshape(L, steps * KSTEP, MAX_TILE, digits)  # tap = 16 half + 4 t + i, lane 4 g + t
    wc = d[..., -1]
    for a in range(digits - 2, -1, -1):
        wc = wc * 256 + d[..., a]
    return torch.where(wc < 0, wc + tab.consts[:, 0, None, None], wc)


def ct_matrix_plain(x0: T, x1: T, tab: Tables) -> T:
    """The layer on the stack (x0, x1) ``[K, L, N]``: ``[2, J, L, N]``, in
    128-bit sums folded every ``tab.fold`` products, every tile at once,
    one tap a step."""
    x = torch.stack((x0, x1))  # [2, K, L, N]
    c = [tab.consts[:, i, None] for i in range(4)]  # each [L, 1]
    w = weights(tab)
    tiles = tab.tiles.cpu().numpy()
    n_tiles, most = len(tiles), int(tiles[:, 1].max())
    lo = torch.zeros((2, n_tiles, MAX_TILE, *x.shape[2:]), dtype=torch.int64, device=x.device)
    hi = torch.zeros_like(lo)
    for i in range(most):
        has = tiles[:, 1] > i  # tiles with a tap i
        p = torch.from_numpy(np.where(has, tiles[:, 0] + i, 0)).to(x.device)
        xi = x[:, tab.col[p].long()]  # [2, tiles, L, N]
        wi = w[:, p].permute(1, 2, 0)[..., None]  # [tiles, MAX_TILE, L, 1]
        wi = wi * torch.from_numpy(has).to(x.device)[:, None, None, None]
        plo, phi = u.mul64_128(xi[:, :, None], wi)
        lo, carry = u.add_carry(lo, plo)
        hi = hi + phi + carry
        if (i + 1) % tab.fold == 0:
            lo, hi = _reduce128(lo, hi, *c), torch.zeros_like(hi)
    v = _reduce128(lo, hi, *c)  # [2, tiles, MAX_TILE, L, N]
    out = torch.empty((2, tab.n_out, *x.shape[2:]), dtype=torch.int64, device=x.device)
    for t, row in enumerate(tiles):
        j = torch.from_numpy(row[4 : 4 + row[2]]).to(x.device)
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
    operands = (x0, x1, tab.slabs, tab.tiles, tab.consts)
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
    if (tab.n_in - 1) * x0.stride(0) >= 1 << 31:
        raise ValueError(f"a stack {tuple(x0.shape)} with strides {x0.stride()}: the kernel "
                         "takes inputs less than 2^31 words apart")
    out = torch.empty((2, tab.n_out, limbs, n), dtype=torch.int64, device=x0.device)
    xstr = np.array(x0.stride(), dtype=np.int64)
    _build.launch("ct_matrix", x0.device, (
        x0.data_ptr(), x1.data_ptr(), xstr.ctypes.data, tab.wd.data_ptr(), tab.col.data_ptr(),
        tab.tiles.data_ptr(), tab.slabs.data_ptr(),
        None if tab.bias is None else tab.bias.data_ptr(), tab.consts.data_ptr(), out.data_ptr(),
        tab.slabs.shape[0], tab.wd.shape[1], tab.n_out, n, limbs, tab.digits, tab.nbytes, tab.tb,
        tab.tpw, tab.ss, run_of(tab, n), tab.plane_fold,
    ), lambda: f"a {tab.n_out} x {tab.n_in} layer on {tuple(x0.shape)}", copies=copies,
        record=("ct_matrix", (x0, x1), (tab,)))
    return out
