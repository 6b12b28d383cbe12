"""The twins of examples/bfv_riding.py and examples/dbfv_psi.py at
log N = 8, exact; of examples/ckks_sigmoid.py (above its 7 median bits on
the JAX example's inputs) and examples/dbfv_pir.py (the wanted row
exact); and ``entry.dryrun_multichip`` (the twin of
``__graft_entry__.dryrun_multichip``) on 4 gloo ranks on the CPU at the
log N = 8 set of tests/test_parallel_protocols.py: every stage decrypts
exactly, every rank ends with the same keys and ciphertexts, and no kernel
wrapper is reached inside ``sharded_ntt``.  The JAX examples compute the
same functions of the same numpy-seeded inputs, so their results are held
too (the riding example's closest taxi; the intersection)."""

import numpy as np
import pytest
import torch

from lattigo_tpu_torch.entry import dryrun_multichip
from lattigo_tpu_torch.examples import bfv_riding, ckks_sigmoid, dbfv_pir, dbfv_psi
from lattigo_tpu_torch.models import bfv

torch.set_num_threads(1)

SMALL = dict(log_n=8, t=65537, log_qi=(46, 46), log_pi=(47,), log_qi_mul=(60, 60))


def test_riding_is_exact():
    r = bfv_riding.ride(8, device="cpu")
    assert r["ok"] and r["n_taxis"] == 128
    # the same seeds as examples/bfv_riding.py: its closest taxi
    rng = np.random.default_rng(0)
    rider, taxis = rng.integers(0, 128, 2), rng.integers(0, 128, (128, 2))
    d2 = ((taxis - rider) ** 2).sum(axis=1)
    assert r["closest"] == int(np.argmin(d2)) and r["closest_d2"] == int(d2.min())


def test_riding_main_returns_ok(capsys):
    assert bfv_riding.main(8, device="cpu") is True
    assert "correct: True" in capsys.readouterr().out


def test_psi_is_exact():
    psi = dbfv_psi.Psi(3, 8, device="cpu")
    got = psi.run()
    want = psi.sets[0] & psi.sets[1] & psi.sets[2]
    np.testing.assert_array_equal(got, want)
    assert 0 < int(want.sum()) < psi.params.n


def test_psi_main_returns_ok(capsys):
    assert dbfv_psi.main(2, 8, device="cpu") is True
    assert "correct: True" in capsys.readouterr().out


def test_sigmoid_passes_on_the_jax_examples_inputs(capsys):
    r = ckks_sigmoid.sigmoid(8, device="cpu")
    # examples/ckks_sigmoid.py's inputs: default_rng(1), 128 slots in [-4, 4]
    np.testing.assert_array_equal(r["values"], np.random.default_rng(1).uniform(-4, 4, 128))
    assert r["bits"] > ckks_sigmoid.MIN_BITS and r["levels"] == 4
    assert ckks_sigmoid.main(8, device="cpu") is True
    assert "median precision" in capsys.readouterr().out


def test_pir_retrieves_the_wanted_row(capsys):
    r = dbfv_pir.retrieve(3, 8, device="cpu")
    assert r["ok"] and r["n"] == 256 and r["wanted"] == 2
    assert r["compiled_programs"] == 0  # the CPU runs the cloud step eagerly
    # the JAX example's small set below log N = 13
    p = dbfv_pir.params_for(8)
    assert ([q.bit_length() for q in p.qi], [q.bit_length() for q in p.pi]) == ([47, 47], [48])
    assert dbfv_pir.params_for(13).n == 8192
    assert dbfv_pir.main(2, 8, device="cpu") is True
    assert "retrieved: True" in capsys.readouterr().out


@pytest.fixture(scope="module")
def dryrun():
    return dryrun_multichip(4, device="cpu", backend="gloo",
                            params_idx=bfv.Parameters(**SMALL).gen_from_log_moduli())


def test_dryrun_multichip_is_exact_on_four_ranks(dryrun):
    assert dryrun["ok"].startswith("dryrun_multichip OK: 4-party mesh at log N = 8")
    assert dryrun["backend"] == "gloo" and dryrun["parties"] == 4
    assert len(dryrun["seconds"]) == 4
    stages = ["ckg", "rkg", "rtg", "encrypt", "cross_ntt", "mul_relin", "mul_relin_sharded",
              "rotate", "pcks", "refresh"]
    for seconds in dryrun["seconds"]:
        assert list(seconds) == stages


def test_dryrun_routes_every_sharded_transform_across_ranks(dryrun):
    """Inside sharded_ntt every transform of the ring's N is cross-rank;
    the others take the kernels' routes, whose wrappers run their plain
    versions on the CPU and count no launch."""
    for counts, transforms in zip(dryrun["counts"], dryrun["transforms"]):
        assert all(sum(c.values()) == 0 for c in counts.values())
        assert {t[4] for t in transforms} == {"tile", "cross"}  # N = 256: no four-step


def test_nccl_with_more_ranks_than_cards_raises():
    with pytest.raises(ValueError, match="needs CUDA devices"):
        dryrun_multichip(2, device="cpu", backend="nccl")
    if torch.cuda.device_count() < 2:
        with pytest.raises((ValueError, RuntimeError)):
            dryrun_multichip(2, backend="nccl")
