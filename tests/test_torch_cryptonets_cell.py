"""CryptoNets' MNIST network (``fhe_bench/apps/cryptonets.py``, the cell
``cryptonets_pn14qp438.b8192``) on the CPU at a tiny size: log N = 9 with
PN14QP438's moduli sizes and scale, a 6 x 6 image padded to 7 x 7, 5 maps,
20 -> 6 -> 10, every layer kind kept (the convolution's taps on the padding
left out).

The plaintext-matrix product (``ops/ct_matrix.py``, ``csrc/ct_matrix.cu``):
its plain version against Python integers on random layers, levels and
negative weights, encoded by ``PlainMatrix`` at Lattigo's scale rules (the
weights read back from the kernel's digit tables), on words at q - 1, with
the 128-bit fold forced early and crossed; the kernel's own source (its
tensor-core products as a host loop over the same fragments) built for the
host behind the real wrapper, equal to the plain version for every tile
size and at the edges of its domain (8 digits, 61-bit words, the plane
fold's interval, outputs with no taps, several slabs a group); the
convolution's taps against ``torch.nn.functional.conv2d``.  The
network through the port against ``fhe_bench/reference/cryptonets.py``
within a limit, at the reference's level and scale; the counters of one
call; a stack of plaintexts encrypted in one call."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fhe_bench.apps import cryptonets as app
from fhe_bench.reference import cryptonets as ref_net
from lattigo_tpu_torch import _build
from lattigo_tpu_torch.models import ckks
from lattigo_tpu_torch.models.ckks.cryptonets import conv_taps
from lattigo_tpu_torch.ops import ct_matrix
from lattigo_tpu_torch.ops import number_theory as nt
from lattigo_tpu_torch.ops import u64 as u
from lattigo_tpu_torch.tools import host_build
from lattigo_tpu_torch.utils import profiling

T = torch.Tensor

torch.set_num_threads(1)

CFG = json.loads((Path(__file__).resolve().parents[1] / "fhe_bench" / "tests" / "data"
                  / "tiny_cryptonets.json").read_text())
# The toy's sound readings are 6.6e-8 to 1.6e-7 (6 seeds); the controls read
# 1.2e-6 to 2.5e-6 (the scale 2^30) and 6.5e-4 to 8.9e-4 (float16 weights).
# This seed reads 1.1e-7, 1.9e-6 and 6.6e-4.
LIMIT = 4.5e-7
WL = dict(config="tiny_cryptonets", app="cryptonets", batch=[36], pool=1)
SEED = 2**31 + 77
CPU = torch.device("cpu")


def big_layer(matrix: ckks.PlainMatrix, x: np.ndarray, moduli, scale: float,
              bias_scale: float) -> np.ndarray:
    """The layer in Python integers: ``x`` [2, K, L, N] words, each weight
    round(w scale) and each bias round(b bias_scale), halves away from
    zero, mod each modulus."""
    def rnd(v, s):
        c = int(abs(float(s) * float(v)) + 0.5)
        return -c if float(s) * float(v) < 0 else c

    out = np.zeros((2, matrix.n_out, *x.shape[2:]), dtype=object)
    xo = x.astype(object)
    for j, k, w in zip(matrix.rows, matrix.cols, matrix.values):
        out[:, j] += xo[:, k] * rnd(w, scale)
    if matrix.bias is not None:
        out[0] += np.array([rnd(b, bias_scale) for b in matrix.bias], dtype=object)[:, None, None]
    return out % np.array(moduli, dtype=object)[:, None]


def primes_below_2_61(count: int) -> list[int]:
    """The largest primes below 2^61: (q - 1)^2 near 2^122."""
    out, x = [], (1 << 61) - 1
    while len(out) < count:
        out += [x] if nt.is_prime(x) else []
        x -= 2
    return out


@pytest.mark.parametrize("bits,limbs,n,n_in,n_out,density,fold", [
    (60, 3, 16, 70, 11, 1.0, None),  # dense: tiles of 8 and 3 outputs
    (60, 2, 8, 40, 13, 0.3, 3),  # sparse, a fold every 3 products
    (35, 4, 32, 25, 9, 0.6, None),
    (46, 1, 8, 12, 3, 1.0, 1),  # a fold after every product
    (61, 2, 8, 70, 5, 1.0, None),  # 70 taps cross the 128-bit fold (64 products below 2^61)
    (35, 2, 8, 30, 7, 0.15, None),  # outputs with no taps
])
def test_the_plain_version_is_exact(bits, limbs, n, n_in, n_out, density, fold):
    """Random weights of both signs at the scale 2^34 and biases at the
    scale 2^68 (beyond int64), encoded by ``PlainMatrix``, on words below
    each modulus and on words at q - 1: the plain version equals Python
    integers."""
    rng = np.random.default_rng(bits + limbs + n_in)
    moduli = primes_below_2_61(limbs) if bits == 61 else nt.generate_ntt_primes(bits, 4, limbs)
    rows, cols = np.nonzero(rng.random((n_out, n_in)) < density)
    matrix = ckks.PlainMatrix(rows, cols, rng.uniform(-0.6, 0.6, len(rows)), n_out, n_in,
                              bias=rng.uniform(-2, 2, n_out))
    tab = matrix.tables(moduli, 2.0**34, 2.0**68, CPU)
    if fold is not None:
        tab = dataclasses.replace(tab, fold=fold)
    assert tab.products == len(rows)
    assert bits != 61 or tab.fold < n_in
    top = np.array(moduli, dtype=np.uint64)[:, None] - np.uint64(1)
    for x in (np.stack([rng.integers(0, q, (2, n_in, n), dtype=np.uint64) for q in moduli],
                       axis=2),
              np.broadcast_to(top, (2, n_in, limbs, n)).copy()):
        got = ct_matrix.ct_matrix(u.from_u64(x[0], CPU), u.from_u64(x[1], CPU), tab)
        want = big_layer(matrix, x, moduli, 2.0**34, 2.0**68)
        assert (u.to_u64(got).astype(object) == want).all()


def source_equals_plain(monkeypatch, lib, tab, x0, x1) -> T:
    """The layer through the host build of ``csrc/ct_matrix.cu`` behind the
    real wrapper (one launch), bit-equal to the plain version."""
    want = ct_matrix.ct_matrix(x0, x1, tab)
    with monkeypatch.context() as m:
        m.setattr(_build, "takes_kernel", lambda name, *t: name == "ct_matrix")
        m.setitem(_build.LIBRARIES, "ct_matrix", lib)
        before = _build.launch_counts()["ct_matrix"]
        got = ct_matrix.ct_matrix(x0, x1, tab)
        assert _build.launch_counts()["ct_matrix"] == before + 1
    assert torch.equal(got, want)
    return got


def residue_layer(rows, cols, signed, moduli, n_in, n_out, bias=None):
    """Tables of the taps with the signed integer weights ``signed`` (and
    biases), as residues of each modulus."""
    res = np.array([[int(v) % q for v in signed] for q in moduli], dtype=np.uint64)
    b = None if bias is None else np.array([[int(v) % q for v in bias] for q in moduli],
                                           dtype=np.uint64)
    return ct_matrix.tables(rows, cols, res, b, moduli, n_in, n_out, CPU)


def stack(rng, moduli, n_in, n, word=None):
    """(x0, x1) [n_in, L, n]: random words below each modulus, or every
    word ``word(q)``."""
    if word is None:
        x = np.stack([rng.integers(0, q, (2, n_in, n), dtype=np.uint64) for q in moduli], axis=2)
    else:
        x = np.broadcast_to(np.array([word(q) for q in moduli], dtype=np.uint64)[:, None],
                            (2, n_in, len(moduli), n)).copy()
    return u.from_u64(x[0], CPU), u.from_u64(x[1], CPU)


def edge_case(name, rng):
    """``(tables, x0, x1)`` of the named edge case of the kernel's domain."""
    if name == "negative_8_digits":  # centered weights near -q/2: the widest digits
        moduli = primes_below_2_61(2)
        rows, cols = np.indices((12, 40)).reshape(2, -1)
        half = (min(moduli) - 1) // 2
        signed = [-int(v) for v in rng.integers(1 << 58, half, len(rows), dtype=np.uint64)]
        tab = residue_layer(rows, cols, signed, moduli, 40, 12, bias=[-half] * 12)
        assert tab.digits == 8 and tab.nbytes == 8
        return tab, *stack(rng, moduli, 40, 16)
    if name.startswith("q_minus_1_"):  # every word q - 1, weights +-(2^33 - 1) and -1
        bits = int(name.rsplit("_", 1)[1])
        moduli = primes_below_2_61(2) if bits == 61 else nt.generate_ntt_primes(bits - 1, 4, 2)
        rows, cols = np.indices((9, 33)).reshape(2, -1)
        signed = np.where(np.arange(len(rows)) % 3 == 0, -1,
                          np.where(np.arange(len(rows)) % 2, 1, -1) * ((1 << 33) - 1))
        tab = residue_layer(rows, cols, signed, moduli, 33, 9, bias=[-1] * 9)
        assert tab.digits == 5 and tab.nbytes == -(-bits // 8)
        return tab, *stack(rng, moduli, 33, 16, lambda q: q - 1)
    if name.startswith("plane_fold_"):  # a fold every k-step, or the natural interval crossed
        moduli = nt.generate_ntt_primes(45, 4, 1)  # 46 bits: 6 bytes
        forced = name == "plane_fold_forced"
        n_in = 100 if forced else ct_matrix.plane_fold_of(5, 6) * ct_matrix.KSTEP + 40
        rows, cols = np.indices((3 if forced else 1, n_in)).reshape(2, -1)
        signed = -np.full(len(rows), 0x8080808080, dtype=np.int64)  # every digit -128
        tab = residue_layer(rows, cols, signed, moduli, n_in, rows.max() + 1)
        assert tab.digits == 5 and tab.plane_fold == ct_matrix.plane_fold_of(5, 6) == 204
        if forced:
            tab = dataclasses.replace(tab, plane_fold=2)
        # bytes 0..4 at 255: plane 4 gains 5 * 128 * 255 a tap, and passes the fold's bound
        # 40 taps past the natural interval, unless folded
        return tab, *stack(rng, moduli, n_in, 8, lambda q: (1 << 40) - 1)
    if name == "no_taps":  # outputs 1 and 4 have no taps, output 4 no bias either
        moduli = nt.generate_ntt_primes(34, 4, 3)
        rows = np.array([0, 0, 2, 3, 3, 3])
        cols = np.array([0, 5, 1, 2, 3, 4])
        signed = rng.integers(-(1 << 33), 1 << 33, len(rows))
        tab = residue_layer(rows, cols, signed, moduli, 6, 5, bias=[3, -7, 0, 11, 0])
        return tab, *stack(rng, moduli, 6, 8)
    outputs = int(name.split("_")[0])  # dense layers of 61 (one slab of 8 tiles) and 150
    moduli = nt.generate_ntt_primes(34, 4, 2)  # outputs (19 tiles: slabs of 10 and 9)
    rows, cols = np.indices((outputs, 45)).reshape(2, -1)
    signed = rng.integers(-(1 << 33), 1 << 33, len(rows))
    tab = residue_layer(rows, cols, signed, moduli, 45, outputs,
                        bias=rng.integers(-(1 << 40), 1 << 40, outputs))
    assert (tab.tb, tab.tpw, tab.slabs.shape[0]) == {61: (8, 2, 1), 150: (10, 2, 2)}[outputs]
    return tab, *stack(rng, moduli, 45, 16)


@pytest.mark.parametrize("case", [pytest.param(o, id=str(o)) for o in (1, 2, 3, 8, 11)] + [
    "negative_8_digits", "q_minus_1_35", "q_minus_1_46", "q_minus_1_61", "plane_fold_forced",
    "plane_fold_natural", "no_taps", "61_outputs", "150_outputs"])
def test_the_kernels_source_equals_the_plain_version(monkeypatch, case):
    """``csrc/ct_matrix.cu``'s arithmetic built for the host, behind the
    real wrapper, bit-equal to the plain version: a dense layer of ``case``
    outputs (tiles of 1, 2, 3, 8 and 8 + 3 outputs) and a convolution's
    tiles of 5 maps, a plane fold every k-step and a 128-bit fold every 5
    products, strided inputs; then the edges of the kernel's domain:
    negative weights at 8 digits, every word q - 1 at 35, 46 and 61 bits,
    a fold every 2 k-steps and the natural plane fold crossed with every
    digit at -128, outputs with no taps, one slab of 8 tiles and two of 10
    and 9, two tiles a warp."""
    rng = np.random.default_rng(len(str(case)))
    lib = host_build.load("ct_matrix")
    if isinstance(case, str):
        source_equals_plain(monkeypatch, lib, *edge_case(case, rng))
        return
    outputs = case
    rng = np.random.default_rng(outputs)
    moduli = nt.generate_ntt_primes(60, 4, 3)
    n, n_in = 16, 36
    dense = ckks.PlainMatrix.dense(rng.uniform(-1, 1, (outputs, n_in)),
                                   rng.uniform(-1, 1, outputs))
    rows, cols, values, n_conv = conv_taps(rng.uniform(-1, 1, (5, 5, 5)), 6, 7, 2)
    conv = ckks.PlainMatrix(rows, cols, values, n_conv, n_in)
    x = np.stack([rng.integers(0, q, (n_in, 2, n), dtype=np.uint64) for q in moduli], axis=2)
    x0, x1 = (u.from_u64(x, CPU)[:, h] for h in range(2))  # strided [K, L, N] views
    for matrix in (dense, conv):
        tab = dataclasses.replace(matrix.tables(moduli, 2.0**40, 2.0**50, CPU), fold=5,
                                  plane_fold=1)
        source_equals_plain(monkeypatch, lib, tab, x0, x1)
    tiles = dense.tables(moduli, 2.0**40, 2.0**50, CPU).tiles.cpu().numpy()
    assert sorted(tiles[:, 2]) == sorted([8] * (outputs // 8) + [outputs % 8] * (outputs % 8 > 0))
    tab = conv.tables(moduli, 2.0**40, 2.0**50, CPU)
    assert set(tab.tiles[:, 2].tolist()) == {5} and (tab.tb, tab.tpw, tab.ss) == (1, 1, 4)
    assert (tab.digits, tab.nbytes) == (6, 8)  # weights below 2^40, 60-bit words


def test_the_convolutions_taps_are_conv2d():
    """``conv_taps`` over 28 x 28 pixels padded to 29 x 29 (the cell's):
    845 outputs from 20480 taps, none on the padding; as a matrix on random
    images, ``conv2d`` of stride 2 on the padded images."""
    rng = np.random.default_rng(5)
    w = rng.uniform(-1, 1, (5, 5, 5))
    rows, cols, values, n_out = conv_taps(w, 28, 29, 2)
    assert (n_out, len(rows), cols.max()) == (845, 20480, 28 * 28 - 1)
    images = rng.uniform(0, 1, (3, 28, 28))
    m = np.zeros((n_out, 28 * 28))
    m[rows, cols] = values
    got = images.reshape(3, -1) @ m.T
    want = F.conv2d(F.pad(torch.from_numpy(images)[:, None], (0, 1, 0, 1)),
                    torch.from_numpy(w)[:, None], stride=2).flatten(1).numpy()
    assert np.allclose(got, want, rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def cell():
    a = app.App(CFG, WL, SEED, CPU)
    before = profiling.counters()
    answers = {0: a.call(0)}
    after = profiling.counters()
    counted = {k: after.get(k, 0) - before.get(k, 0)
               for k in ("ckks.ct_matrix.products", "ckks.relinearized")}
    return a, answers, counted


def test_the_network_decrypts_within_the_limit(cell):
    a, answers, _ = cell
    got = a.judge(answers)
    assert got == dict(got, bad_form=0, limb_mismatch=0, out_of_range=0)
    assert 0 < got["max_err"] <= LIMIT, got
    logits = ref_net.expected(CFG, a.w, a.pixels[0])
    assert logits.shape == (256, 10) and np.abs(logits).max() > 0.1


def test_level_and_scale_are_the_references(cell):
    """Five rescales from level 9, one modulus each; ten logits a batch."""
    a, answers, _ = cell
    scale, level = app.result_form(CFG)
    steps, _, _ = ref_net.trace(ckks.get_context(app.parameters(CFG), CPU).ring_q.moduli,
                                float(CFG["scale"]), 9)
    assert [d for _, _, d in steps] == [[9], [8], [7], [6], [5]] and level == 4
    ans = answers[0]
    assert ans.degree == 1 and ans.level == level and ans.scale == scale
    assert tuple(ans.value[0].shape) == (10, 5, 512)


def test_the_counters_of_one_call(cell):
    """One call: the nonzero taps of the three layers (20 x 25 less the
    padding's, 6 x 20, 10 x 6) and the two squares' stacks (20 + 6)."""
    _, _, counted = cell
    conv = sum(min(5, 6 - 2 * i) for i in range(2)) ** 2 * 5
    assert conv == 405
    assert counted == {"ckks.ct_matrix.products": conv + 6 * 20 + 10 * 6,
                       "ckks.relinearized": 20 + 6}


def test_a_layer_refuses_a_stack_of_another_size(cell):
    """The first dense layer (6 x 20) on the 36 input pixels; a tap given
    twice."""
    a, _, _ = cell
    ev = ckks.Evaluator(app.parameters(CFG), device=CPU)
    with pytest.raises(ValueError, match="6 x 20 matrix"):
        ev.mul_plain_matrix(a.cts[0], a.net.dense1)
    twice = ckks.PlainMatrix([0, 0], [1, 1], [0.5, 0.25], 2, 3)
    with pytest.raises(ValueError, match="twice"):
        twice.tables([97], 2.0**10, 2.0**20, CPU)


@pytest.mark.parametrize("key", ["pk", "sk"])
def test_a_stack_of_plaintexts_is_encrypted_in_one_call(key):
    """``Encryptor.encrypt`` of a plaintext with a leading dim of 3: each
    decrypts to its own slots, with draws of its own (no two masks equal)."""
    params = app.parameters(CFG)
    kgen = ckks.KeyGenerator(params, device=CPU, seed=4)
    sk = kgen.gen_secret_key()
    enc = ckks.Encoder(params, device=CPU)
    values = np.random.default_rng(2).uniform(-1, 1, (3, 256))
    keys = dict(pk=kgen.gen_public_key(sk)) if key == "pk" else dict(sk=sk)
    ct = ckks.Encryptor(params, device=CPU, seed=8, **keys).encrypt(enc.encode(values))
    assert tuple(ct.value[0].shape) == (3, 10, 512)
    got = enc.decode(ckks.Decryptor(params, sk, device=CPU).decrypt(ct))
    assert np.abs(got - values).max() < 1e-6
    c1 = ct.value[1]
    assert not (torch.equal(c1[0], c1[1]) or torch.equal(c1[1], c1[2]))
