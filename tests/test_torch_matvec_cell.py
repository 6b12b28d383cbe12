"""The benchmark's encrypted dense layer (``fhe_bench/apps/ckks_matvec.py``,
the cell ``ckks_pn14qp438.fc1024x8192``) on the CPU at log N = 10 with
PN14QP438's moduli sizes and scale and a 32 x 512 layer of seeded random
weights (8 baby x 4 giant steps, 4 fold steps): the port's
``mul_matrix_hybrid`` decrypting within a limit of the plain reference's
``W x`` (``fhe_bench/reference/matvec.py``), at the reference's level and
scale; the cell's program, one ``tjit`` of the layer on the plain
``ckks.Evaluator``, equal to the eager layer on two content-distinct
ciphertexts; its counters; the diagonals' order; the diagonals against the
port's own encoder."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from fhe_bench.apps import ckks_matvec as app
from fhe_bench.reference import matvec as ref_matvec
from lattigo_tpu_torch.models import ckks
from lattigo_tpu_torch.models.ckks import linear_transform
from lattigo_tpu_torch.models.ckks.encoder import scale_up_vec_exact
from lattigo_tpu_torch.utils import profiling

torch.set_num_threads(1)

CFG = json.loads((Path(__file__).resolve().parents[1] / "fhe_bench" / "tests" / "data"
                  / "tiny_matvec.json").read_text())
# The toy's sound readings are 2.8e-8 to 7.6e-8 (6 seeds; the encryption
# noise, about 2^-25 a slot at the scale 2^34, summed over 512 weights of
# 0.08 at most); at the scale 2^30, the control's, 3.4e-7 or more.  1.6e-7
# lies between.
LIMIT = 1.6e-7
WL = dict(config="tiny_matvec", app="ckks_matvec", batch=[], pool=2)
SEED = 2**31 + 29
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def cell():
    a = app.App(CFG, WL, SEED, CPU)
    before = profiling.counters()
    answers = {k: a.call(k) for k in range(a.pool)}
    after = profiling.counters()
    counted = {k: after.get(k, 0) - before.get(k, 0) for k in
               ("ckks.rotations", "ckks.decompositions", "ckks.linear.pt_products")}
    return a, answers, counted


def evaluator():
    return ckks.Evaluator(app.parameters(CFG), device=CPU)


def test_the_layer_decrypts_to_w_x_within_the_limit(cell):
    a, answers, _ = cell
    got = a.judge(answers)
    assert got == dict(got, bad_form=0, limb_mismatch=0, out_of_range=0)
    assert 0 < got["max_err"] <= LIMIT, got
    # the reference's answer: every block of 32 slots holds W x
    assert np.abs(ref_matvec.expected(a.w, a.values)[:, :32] - a.values @ a.w.T).max() == 0


def test_level_and_scale_are_the_references(cell):
    a, answers, _ = cell
    scale, level, divided = app.result_form(CFG)
    assert (level, divided) == (8, [9])
    for ans in answers.values():
        assert ans.degree == 1 and ans.level == level and ans.scale == scale
    assert scale == 2.0**68 / float(ckks.get_context(app.parameters(CFG), CPU).ring_q.moduli[9])


def test_the_program_equals_the_eager_layer(cell):
    """Both pool entries (content-distinct): the program's answer against
    ``mul_matrix_hybrid`` run eagerly, bit for bit."""
    a, answers, _ = cell
    ev = evaluator()
    assert not torch.equal(a.cts[0].value[0], a.cts[1].value[0])
    for k in range(2):
        eager = ckks.mul_matrix_hybrid(ev, a.cts[k], a.diags, a.rot_keys)
        assert eager.scale == answers[k].scale
        assert all(torch.equal(x, y) for x, y in zip(eager.value, answers[k].value))
    assert not torch.equal(answers[0].value[0], answers[1].value[0])


def test_the_counters_of_a_call(cell):
    """7 baby + 3 giant + 4 fold rotations; 1 hoisted + 3 + 4
    decompositions; 32 plaintext products: each of two calls."""
    _, _, counted = cell
    assert counted == {"ckks.rotations": 2 * (7 + 3 + 4), "ckks.decompositions": 2 * (1 + 3 + 4),
                       "ckks.linear.pt_products": 2 * 32}
    assert linear_transform.rotations(32, 8, 512) == (list(range(1, 8)), [8, 16, 24],
                                                      [256, 128, 64, 32])


def test_a_wrong_diagonal_order_fails_the_limit(cell):
    """The baby steps' diagonals reversed within each giant step: the layer
    computes another matrix's product."""
    a, _, _ = cell
    wrong = ckks.Diagonals(a.diags.value.flip(1), a.diags.scale)
    out = ckks.mul_matrix_hybrid(evaluator(), a.cts[0], wrong, a.rot_keys)
    got = a.judge({0: out})
    assert got["bad_form"] == 0 and got["max_err"] > 1000 * LIMIT, got


def test_the_diagonals_are_the_encoders(cell):
    """Each pre-rotated diagonal is the port's ``Encoder.encode`` of it
    alone, in Montgomery form, bit for bit; the int64 rounding of
    ``scale_up_vec_exact`` gives the words of its big-integer rounding
    (taken where scale x value reaches 2^63)."""
    a, _, _ = cell
    params = app.parameters(CFG)
    ring = ckks.get_context(params, CPU).ring_q
    enc = ckks.Encoder(params, device=CPU)
    for j, i in ((0, 0), (1, 5), (3, 7)):
        diag = linear_transform.pre_rotated(a.w, CFG["baby_steps"], j)[i]
        assert torch.equal(ring.mform(enc.encode(diag).value), a.diags.value[j, i])
    x = np.random.default_rng(3).uniform(-1, 1, (2, 64)) * 2.0**np.arange(0, 64)
    x[0, :3] = (-0.5, 0.5, -2.5)  # halves away from zero
    big = scale_up_vec_exact(np.concatenate([x, [[2.0**70]] * 2], axis=-1), 1.0, ring.moduli,
                             CPU)
    assert torch.equal(scale_up_vec_exact(x, 1.0, ring.moduli, CPU), big[..., :-1])
