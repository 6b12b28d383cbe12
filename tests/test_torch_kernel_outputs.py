"""The rule ``tjit``'s copy-skip relies on, for each of the kernel
wrappers behind ``_build`` (one a C entry): a call returns a tensor the wrapper allocated
(not an input, not a view of one), hands that tensor to the C entry to
write, and leaves its inputs' contents and ``_version`` as they were.

CPU tensors go down every kernel path (the seam's device rule set aside)
to a library behind the seam whose entries launch nothing and record their
arguments.  Rings of log N = 8, but for the wrappers that take no ring that
small: the long-row kernel's (N from 1024) and the four-step kernel's
(N from 4096).  And the counts: an eager PN12QP109 forward through that
library counts what the parent's counters did.  No JAX.
"""

import numpy as np
import pytest
import torch

from lattigo_tpu_torch import _build
from lattigo_tpu_torch.entry import entry
from lattigo_tpu_torch.ops import basis_ext, ct_matrix, galois, key_switch, mxu_ntt, pallas_ntt
from lattigo_tpu_torch.ops import tile_ntt
from lattigo_tpu_torch.ops import modred_kernel as mk
from lattigo_tpu_torch.ops import number_theory as nt
from lattigo_tpu_torch.ops import u64 as u
from lattigo_tpu_torch.ops.ring import Ring

torch.set_num_threads(1)


class NullLib:
    """Every C entry records its arguments, launches nothing and returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, symbol):
        if not symbol.endswith("_launch"):
            raise AttributeError(symbol)
        return lambda *args: self.calls.append((symbol, args)) or 0


def residues(rng, ring: Ring, shape) -> torch.Tensor:
    """Words below each limb's modulus, ``shape`` = (..., L, N)."""
    q = np.array(ring.moduli[: shape[-2]], dtype=np.uint64)[:, None]
    return u.from_u64(rng.integers(0, 1 << 62, size=shape, dtype=np.uint64) % q, "cpu")


def ring_of(log_n: int, limbs: int) -> Ring:
    return Ring(1 << log_n, nt.generate_ntt_primes(50, log_n, limbs), device="cpu")


def ntt_call(wrapper, log_n: int):
    def make(rng):
        ring = ring_of(log_n, 2)
        x = residues(rng, ring, (3, 2, ring.n))
        return lambda: wrapper(ring, x, (1, 0)), [x]
    return make


def modred_call(rng):
    ring = ring_of(8, 3)
    wide = residues(rng, ring, (2, 3, ring.n))
    x = wide.transpose(0, 1).contiguous().transpose(0, 1)  # no single batch stride: one copy
    y = wide[:1]  # broadcast over the batch
    return lambda: mk.mred_add(x, y, wide, ring.q_, ring.qinv_), [x, y, wide]


def mod_up_call(rng):
    src = ring_of(8, 5)
    mp = basis_ext.ModUpParams(src.moduli[:2], src.moduli[2:], "cpu")
    x = residues(rng, src, (3, 2, src.n))
    return lambda: basis_ext.mod_up(x[1:], mp, [2, 0]), [x]


def key_switch_call(rng):
    ring = ring_of(8, 4)
    d = residues(rng, ring, (2, 3, 3, ring.n))  # [B, beta, L, N]
    key0, key1 = (residues(rng, ring, (3, 4, ring.n)) for _ in range(2))
    index = galois.ntt_index(5, ring.n, "cpu")
    return (lambda: key_switch.inner_product(d, key0, key1, ring, (0, 2, 3), 3, index=index),
            [d, key0, key1, index])


def decompose_call(rng):
    ring = ring_of(8, 7)
    dec = basis_ext.Decomposer(ring.moduli[:5], ring.moduli[5:], "cpu")  # 3 digits at level 4
    x = residues(rng, ring, (2, 5, ring.n))
    return lambda: dec.decompose(4, x), [x]


def ct_matrix_call(rng):
    ring = ring_of(8, 3)
    x = residues(rng, ring, (5, 2, 3, ring.n))  # [K, 2, L, N]: two strided halves
    rows, cols = np.nonzero(rng.random((4, 5)) < 0.7)
    w = np.stack([rng.integers(0, q, len(rows), dtype=np.uint64) for q in ring.moduli])
    tab = ct_matrix.tables(rows, cols, w, None, ring.moduli, 5, 4, "cpu")
    return lambda: ct_matrix.ct_matrix(x[:, 0], x[:, 1], tab), [x]


CALLS = {
    "ntt_row": ntt_call(tile_ntt.ntt_tile, 8),
    "ntt_passes": ntt_call(pallas_ntt.ntt_passes, 10),
    "ntt_fourstep": ntt_call(mxu_ntt.ntt_mxu, 12),
    "modred": modred_call,
    "mod_up": mod_up_call,
    "key_switch": key_switch_call,
    "decompose": decompose_call,
    "ct_matrix": ct_matrix_call,
}


@pytest.mark.parametrize("name", list(_build.ENTRIES))
def test_a_wrapper_returns_a_tensor_of_its_own_and_leaves_its_inputs(monkeypatch, name):
    assert set(CALLS) == set(_build.ENTRIES)
    lib = NullLib()
    monkeypatch.setattr(_build, "takes_kernel", lambda source, *tensors: True)
    for source in _build.SOURCES:
        monkeypatch.setitem(_build.LIBRARIES, source, lib)
    call, inputs = CALLS[name](np.random.default_rng(len(name)))
    before = [(t.clone(), t._version) for t in inputs]
    out = call()
    symbol = _build.ENTRIES[name].symbol
    mine = [args for s, args in lib.calls if s == symbol]
    assert len(mine) == 1, lib.calls
    assert out.data_ptr() in mine[0]  # the entry is handed the result to write
    storage = out.untyped_storage().data_ptr()
    for t, (contents, version) in zip(inputs, before, strict=True):
        assert out is not t and storage != t.untyped_storage().data_ptr()
        assert torch.equal(t, contents) and t._version == version


def test_the_key_switch_writes_a_given_out_and_bumps_its_version(monkeypatch):
    """``inner_product(..., out=o)`` hands ``o`` to the C entry, returns
    it, bumps its ``_version`` (the write is seen by ``tjit``'s copy-skip)
    and leaves the inputs as they were; an ``out`` of another shape or not
    contiguous is refused before any launch."""
    lib = NullLib()
    monkeypatch.setattr(_build, "takes_kernel", lambda source, *tensors: True)
    monkeypatch.setitem(_build.LIBRARIES, "key_switch", lib)
    _, inputs = key_switch_call(np.random.default_rng(3))
    d, key0, key1, index = inputs
    ring = ring_of(8, 4)
    run = lambda o: key_switch.inner_product(d, key0, key1, ring, (0, 2, 3), 3, index=index, out=o)
    before = [(t.clone(), t._version) for t in inputs]
    o = torch.empty((5, 2, 2, 3, ring.n), dtype=torch.int64)[1]
    version = o._version
    assert run(o) is o and o._version > version
    assert len(lib.calls) == 1 and o.data_ptr() in lib.calls[0][1]
    for t, (contents, v) in zip(inputs, before, strict=True):
        assert torch.equal(t, contents) and t._version == v
    for bad in (torch.empty((2, 2, 4, ring.n), dtype=torch.int64),
                torch.empty((2, 2, 3, 2 * ring.n), dtype=torch.int64)[..., ::2]):
        with pytest.raises(ValueError, match="no contiguous"):
            run(bad)
    assert len(lib.calls) == 1


def test_an_eager_forward_counts_what_the_parent_counted(monkeypatch):
    """``entry()``'s PN12QP109 forward with every kernel behind the fake
    library: ``launch_counts()`` has the keys and values the parent's
    counters gave (``chip_smoke.py``'s ``main_path`` on the card: 7 + 4
    long-row transforms, 22 modular passes, 8 basis extensions, 1 key
    switch), and no launch of the CKKS decomposition (BFV keeps its own)
    nor of the plaintext-matrix product."""
    forward, args = entry(device="cpu")
    monkeypatch.setattr(_build, "takes_kernel", lambda source, *tensors: True)
    for source in _build.SOURCES:
        monkeypatch.setitem(_build.LIBRARIES, source, NullLib())
    _build.reset_launch_counts()
    forward(*args)
    assert _build.launch_counts() == {
        "ntt_tile_fwd": 0, "ntt_tile_inv": 0, "ntt_mxu_fwd": 0, "ntt_mxu_inv": 0,
        "ntt_passes_fwd": 7, "ntt_passes_inv": 4, "modred": 22, "mod_up": 8, "key_switch": 1,
        "decompose": 0, "ct_matrix": 0}
