"""CryptoNets' MNIST network (``fhe_bench/apps/cryptonets.py``, the cell
``cryptonets_pn14qp438.b8192``) on the CPU at a tiny size: log N = 9 with
PN14QP438's moduli sizes and scale, a 6 x 6 image padded to 7 x 7, 5 maps,
20 -> 6 -> 10, every layer kind kept (the convolution's taps on the padding
left out).

The plaintext-matrix product (``ops/ct_matrix.py``, ``csrc/ct_matrix.cu``):
its plain version against Python integers on random layers, levels and
negative weights, encoded by ``PlainMatrix`` at Lattigo's scale rules, with
the 128-bit fold forced early; the kernel's own source built for the host
behind the real wrapper, equal to the plain version for every tile size;
the convolution's taps against ``torch.nn.functional.conv2d``.  The
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


@pytest.mark.parametrize("bits,limbs,n,n_in,n_out,density,fold", [
    (60, 3, 16, 70, 11, 1.0, None),  # dense: tiles of 8 and 3 outputs
    (60, 2, 8, 40, 13, 0.3, 3),  # sparse, a fold every 3 products
    (35, 4, 32, 25, 9, 0.6, None),
    (46, 1, 8, 12, 3, 1.0, 1),  # a fold after every product
])
def test_the_plain_version_is_exact(bits, limbs, n, n_in, n_out, density, fold):
    """Random weights of both signs at the scale 2^34 and biases at the
    scale 2^68 (beyond int64), encoded by ``PlainMatrix``, on words below
    each modulus: the plain version equals Python integers."""
    rng = np.random.default_rng(bits + limbs + n_in)
    moduli = nt.generate_ntt_primes(bits, 4, limbs)
    rows, cols = np.nonzero(rng.random((n_out, n_in)) < density)
    matrix = ckks.PlainMatrix(rows, cols, rng.uniform(-0.6, 0.6, len(rows)), n_out, n_in,
                              bias=rng.uniform(-2, 2, n_out))
    tab = matrix.tables(moduli, 2.0**34, 2.0**68, CPU)
    if fold is not None:
        tab = dataclasses.replace(tab, fold=fold)
    assert tab.products == len(rows)
    x = np.stack([rng.integers(0, q, (2, n_in, n), dtype=np.uint64) for q in moduli], axis=2)
    got = ct_matrix.ct_matrix(u.from_u64(x[0], CPU), u.from_u64(x[1], CPU), tab)
    want = big_layer(matrix, x, moduli, 2.0**34, 2.0**68)
    assert (u.to_u64(got).astype(object) == want).all()


@pytest.mark.parametrize("outputs", [1, 2, 3, 8, 11])
def test_the_kernels_source_equals_the_plain_version(monkeypatch, outputs):
    """``csrc/ct_matrix.cu``'s arithmetic built for the host, behind the
    real wrapper: tiles of 1, 2, 4 and 8 outputs (a dense layer of
    ``outputs``), a convolution's tiles, a fold every 5 products, strided
    inputs; bit-equal to the plain version."""
    rng = np.random.default_rng(outputs)
    moduli = nt.generate_ntt_primes(60, 4, 3)
    n, n_in = 16, 36
    dense = ckks.PlainMatrix.dense(rng.uniform(-1, 1, (outputs, n_in)),
                                   rng.uniform(-1, 1, outputs))
    rows, cols, values, n_conv = conv_taps(rng.uniform(-1, 1, (5, 5, 5)), 6, 7, 2)
    conv = ckks.PlainMatrix(rows, cols, values, n_conv, n_in)
    x = np.stack([rng.integers(0, q, (n_in, 2, n), dtype=np.uint64) for q in moduli], axis=2)
    x0, x1 = (u.from_u64(x, CPU)[:, h] for h in range(2))  # strided [K, L, N] views
    lib = host_build.load("ct_matrix")
    for matrix in (dense, conv):
        tab = dataclasses.replace(matrix.tables(moduli, 2.0**40, 2.0**50, CPU), fold=5)
        want = ct_matrix.ct_matrix(x0, x1, tab)
        with monkeypatch.context() as m:
            m.setattr(_build, "takes_kernel", lambda name, *t: name == "ct_matrix")
            m.setitem(_build.LIBRARIES, "ct_matrix", lib)
            before = _build.launch_counts()["ct_matrix"]
            got = ct_matrix.ct_matrix(x0, x1, tab)
            assert _build.launch_counts()["ct_matrix"] == before + 1
        assert torch.equal(got, want)
    tile = min(8, 1 << (outputs - 1).bit_length())
    assert dense.tables(moduli, 2.0**40, 2.0**50, CPU).tile == tile
    assert conv.tables(moduli, 2.0**40, 2.0**50, CPU).tile == 8  # 5 maps a position


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
