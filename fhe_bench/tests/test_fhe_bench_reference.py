"""The plain reference against the port on the CPU: Lattigo's moduli and NTT
order, known answers decrypted, and the yardstick's figures."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from fhe_bench import roofline
from fhe_bench.reference import bfv as ref_bfv
from fhe_bench.reference import ckks as ref_ckks
from fhe_bench.reference.ring import NTT, mulmod
from fhe_bench.tests.data import tiny
from lattigo_tpu_torch.models import bfv, ckks

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def test_moduli_are_the_ports():
    pir = json.loads((CONFIGS / "dbfv_pir_pn13qp218.json").read_text())
    got = ref_bfv.moduli(pir)
    want = bfv.default_params(bfv.PN13QP218)
    assert (tuple(got["q"]), tuple(got["p"]), tuple(got["qmul"])) == (want.qi, want.pi, want.qi_mul)
    cks = json.loads((CONFIGS / "ckks_pn16qp1761.json").read_text())
    got = ref_ckks.moduli(cks)
    want = ckks.default_params(ckks.PN16QP1761)
    assert (tuple(got["q"]), tuple(got["p"])) == (want.qi, want.pi)
    assert float(cks["scale"]) == want.scale


def test_mulmod_exact_at_the_edges():
    q = torch.tensor([(1 << 56) - 5, (1 << 54) + 1])[:, None]
    a = torch.stack([q[:, 0] - 1, q[:, 0] - 2, torch.tensor([1, 1]), torch.tensor([12345, 0])], 1)
    got = mulmod(a, a.flip(1), q)
    for i in range(2):
        qi = int(q[i, 0])
        want = [int(x) * int(y) % qi for x, y in zip(a[i].tolist(), a[i].flip(0).tolist())]
        assert got[i].tolist() == want


@pytest.mark.parametrize("log_n", [8, 10])
def test_ntt_is_lattigos_order(log_n):
    params = bfv.Parameters(log_n=log_n, t=65537, log_qi=(54, 54), log_pi=(55,),
                            log_qi_mul=(60, 60)).gen_from_log_moduli()
    ring = bfv.get_context(params, "cpu").ring_qp
    x = torch.from_numpy(np.stack([np.random.default_rng(log_n).integers(0, q, ring.n)
                                   for q in ring.moduli]))
    f = NTT(ring.moduli, ring.n)
    assert torch.equal(f.forward(x), ring.ntt(x))
    assert torch.equal(f.inverse(ring.ntt(x)), x)


def test_bfv_decrypts_known_answers():
    cfg = tiny.PIR_CFG
    params = bfv.Parameters(log_n=cfg["log_n"], t=cfg["t"], log_qi=tuple(cfg["log_qi"]),
                            log_pi=tuple(cfg["log_pi"]),
                            log_qi_mul=tuple(cfg["log_qi_mul"])).gen_from_log_moduli()
    ctx = bfv.get_context(params, "cpu")
    rng = np.random.default_rng(5)
    s = rng.integers(-1, 2, ctx.n)
    from fhe_bench.apps.pir_cloud import port_secret

    sk = port_secret(ctx.ring_qp, s)
    pk = bfv.KeyGenerator(params, device="cpu", seed=3).gen_public_key(sk)
    values = rng.integers(0, 256, ctx.n)
    pt = bfv.Encoder(params, device="cpu").encode_uint(values.astype(np.uint64))
    ct = torch.stack(bfv.Encryptor(params, pk=pk, device="cpu", seed=7).encrypt(pt).value)
    scheme = ref_bfv.Scheme(cfg)
    got = scheme.judge(ct, torch.from_numpy(s), torch.from_numpy(values))
    assert got["wrong_slots"] == 0 and got["noise"] < 1e-10
    other = scheme.judge(ct, torch.from_numpy(s), torch.from_numpy((values + 1) % 65537))
    assert other["wrong_slots"] == ctx.n and other["noise"] >= 1


def test_ckks_decrypts_known_answers():
    cfg = tiny.CKKS_CFG
    scheme = ref_ckks.Scheme(cfg)
    rng = np.random.default_rng(2)
    values = rng.uniform(-1, 1, (2, scheme.slots)) + 1j * rng.uniform(-1, 1, (2, scheme.slots))
    coeffs = scheme.encode(values)
    assert np.abs(scheme.decode(coeffs.astype(float), scheme.scale) - values).max() < 1e-9
    params = ckks.Parameters(log_n=cfg["log_n"], log_slots=cfg["log_slots"], scale=float(cfg["scale"]),
                             log_qi=tuple(cfg["log_qi"]), log_pi=tuple(cfg["log_pi"])).gen_from_log_moduli()
    enc = ckks.Encoder(params, device="cpu")
    ring = ckks.get_context(params, "cpu").ring_q
    pt = ckks.Plaintext(ring.ntt(torch.from_numpy(coeffs[0])[None] % torch.tensor(ring.moduli)[:, None]),
                        params.scale)
    assert np.abs(enc.decode(pt) - values[0]).max() < 1e-9  # the port reads the slots alike
    s = np.zeros(scheme.n, dtype=np.int64)
    s[rng.choice(scheme.n, 64, replace=False)] = rng.choice([-1, 1], 64)
    from fhe_bench.apps.pir_cloud import port_secret

    sk = ckks.SecretKey(port_secret(ckks.get_context(params, "cpu").ring_qp, s).sk)
    ct = ckks.Encryptor(params, sk=sk, device="cpu", seed=1).encrypt(pt)
    got = scheme.judge(torch.stack(ct.value), torch.from_numpy(s), values[0], params.scale,
                       len(params.qi) - 1)
    assert got["limb_mismatch"] == 0 and got["max_err"] < 1e-9
    wrong = scheme.judge(torch.stack(ct.value), torch.from_numpy(-s), values[0], params.scale,
                         len(params.qi) - 1)
    assert wrong["limb_mismatch"] > 0


@pytest.mark.parametrize("kind, rows, limbs, n, want_ms", [
    ("fourstep", 2048, 2, 8192, 0.2083),  # [1024, 2, 8192], bound by its int8 operations
    ("fourstep", 72, 3, 8192, 0.00732),   # [3, 8, 3, 8192]
    ("butterfly", 2736, 38, 65536, 0.868),  # [8, 9, 38, 65536], the long-row kernel's bytes
])
def test_roofline_reproduces_perf_md(kind, rows, limbs, n, want_ms):
    fn = roofline.fourstep_bound_s if kind == "fourstep" else roofline.ntt_bound_s
    assert fn(rows, limbs, n) * 1e3 == pytest.approx(want_ms, rel=1e-3)  # as PERF.md rounds


def test_work_files_bound():
    work = json.loads((CONFIGS.parent / "work" / "pir_pn13qp218.rows8.json").read_text())
    assert roofline.work_bound_s(work) * 1e3 == pytest.approx(0.1143, rel=1e-3)
