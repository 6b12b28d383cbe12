"""The threshold protocols on a party group of 4 gloo ranks (CPU), one
party a rank, at the log N = 8 set of tests/test_parallel_protocols.py.

* Every ``*_mesh`` protocol decrypts exactly under the parties' summed key
  (the target key for CKS / PCKS), as tests/test_parallel_protocols.py
  checks the JAX package; ``refresh_mesh_dckks`` restores the level at 10
  median bits or more.  The keys and ciphertexts each rank ends with are
  equal on every rank (the combined shares are).
* ``collective_keygen_mesh`` equals the sequential fold of the same shares
  made with the same per-party generators (``party_seed``), bit for bit.
* With the JAX package's Gaussian draws substituted for the port's (the
  draws of its ``collective_keygen_mesh``, recomputed from its key
  schedule), ``collective_keygen_mesh`` equals the JAX function's output bit
  for bit."""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from lattigo_tpu.models import bfv as jbfv
from lattigo_tpu.models import dbfv as jdbfv
from lattigo_tpu.ops import samplers as jsamplers
from lattigo_tpu.ops import u64 as ju
from lattigo_tpu.parallel import protocols as jpp
from lattigo_tpu.parallel.mesh import make_mesh as jax_mesh
from lattigo_tpu.utils.prng import CRPGenerator as JCRP
from lattigo_tpu_torch.models import bfv, ckks, dbfv, dckks
from lattigo_tpu_torch.ops import samplers
from lattigo_tpu_torch.ops import u64 as tu
from lattigo_tpu_torch.parallel import protocols as pp
from lattigo_tpu_torch.parallel.launch import World
from lattigo_tpu_torch.utils.precision import precision_stats
from lattigo_tpu_torch.utils.prng import CRPGenerator

torch.set_num_threads(1)

SPEC = dict(log_n=8, t=65537, log_qi=(46, 46), log_pi=(47,), log_qi_mul=(60, 60))
CKKS_SPEC = dict(log_n=8, log_slots=7, scale=float(1 << 32), log_qi=(45, 32, 32, 32),
                 log_pi=(45,))
N_PARTIES = 4
CPU = "cpu"


def _np(x: torch.Tensor) -> np.ndarray:
    return tu.to_u64(x)


def _keys(params, scheme, seed0):
    ctx = scheme.get_context(params, CPU)
    sks = [scheme.KeyGenerator(params, device=CPU, seed=seed0 + i).gen_secret_key().sk
           for i in range(N_PARTIES)]
    acc = sks[0]
    for s in sks[1:]:
        acc = ctx.ring_qp.add(acc, s)
    return ctx, sks, acc


def _bfv_protocols_rank():
    """Every dBFV ``*_mesh`` protocol, each checked by decryption; what each
    decrypted to, what it should have, and the bytes of every key and
    ciphertext made (to compare across ranks)."""
    params = bfv.Parameters(**SPEC).gen_from_log_moduli()
    ctx, sks, acc = _keys(params, bfv, 50)
    group = None
    crpg = CRPGenerator(b"meshtest", ctx.ring_qp)
    crpg.seed(b"s")
    pk = pp.ckg_mesh(dbfv.CKGProtocol(params, device=CPU, seed=1), group, sks, crpg.clock_poly())
    enc = bfv.Encoder(params, device=CPU)
    encryptor = bfv.Encryptor(params, pk=pk, device=CPU)
    decode = lambda ct, sk=acc: enc.decode_uint(
        bfv.Decryptor(params, bfv.SecretKey(sk), device=CPU).decrypt(ct))
    rng = np.random.default_rng(11)
    msg = lambda: rng.integers(0, params.t, params.n, dtype=np.uint64)
    out, made = {}, {"pk": [_np(p) for p in pk.pk]}

    m = msg()
    out["ckg"] = (decode(encryptor.encrypt(enc.encode_uint(m))), m)

    _, tgt, tgt_acc = _keys(params, bfv, 70)
    m = msg()
    ct = pp.cks_mesh(dbfv.CKSProtocol(params, device=CPU, seed=2), group, sks, tgt,
                     encryptor.encrypt(enc.encode_uint(m)))
    out["cks"], made["cks"] = (decode(ct, tgt_acc), m), [_np(p) for p in ct.value]

    sk_out, pk_out = bfv.KeyGenerator(params, device=CPU, seed=90).gen_key_pair()
    m = msg()
    ct = pp.pcks_mesh(dbfv.PCKSProtocol(params, device=CPU, seed=3), group, sks, pk_out,
                      encryptor.encrypt(enc.encode_uint(m)))
    out["pcks"], made["pcks"] = (decode(ct, sk_out.sk), m), [_np(p) for p in ct.value]

    rlk = pp.rkg_mesh(dbfv.RKGProtocol(params, device=CPU, seed=4), group, sks,
                      crpg.clock_polys(params.beta))
    ev = bfv.Evaluator(params, device=CPU)
    a, b = msg(), msg()
    ct = ev.relinearize(ev.mul(*[encryptor.encrypt(enc.encode_uint(v)) for v in (a, b)]), rlk)
    out["rkg"], made["rlk"] = (decode(ct), a * b % np.uint64(params.t)), [
        _np(rlk.evakey[0].key0), _np(rlk.evakey[0].key1)]

    rot_keys = pp.rtg_mesh(dbfv.RTGProtocol(params, device=CPU, seed=5), group, "left", 1, sks,
                           crpg.clock_polys(params.beta), bfv.RotationKeys())
    m = msg()
    half = params.n // 2
    out["rtg"] = (decode(ev.rotate_columns(encryptor.encrypt(enc.encode_uint(m)), 1, rot_keys)),
                  np.concatenate([np.roll(m[:half], -1), np.roll(m[half:], -1)]))
    made["rtg"] = [_np(rot_keys.left[1].key0)]

    m = msg()
    ct = pp.refresh_mesh(dbfv.RefreshProtocol(params, device=CPU, seed=6), group, sks,
                         encryptor.encrypt(enc.encode_uint(m)), crpg.clock_poly())
    out["refresh"], made["refresh"] = (decode(ct), m), [_np(p) for p in ct.value]
    return out, made


def _dckks_refresh_rank():
    """dCKKS keys on the mesh, then refresh_mesh_dckks of a ciphertext two
    levels down: (level after, top level, median bits, bytes of the result)."""
    params = ckks.Parameters(**CKKS_SPEC).gen_from_log_moduli()
    ctx, sks, acc = _keys(params, ckks, 70)
    sk_col = ckks.SecretKey(acc)
    enc = ckks.Encoder(params, device=CPU)
    ev = ckks.Evaluator(params, device=CPU)
    rng = np.random.default_rng(12)
    v = rng.uniform(-1, 1, params.slots) + 1j * rng.uniform(-1, 1, params.slots)
    ct = ev.drop_level(ckks.Encryptor(params, sk=sk_col, device=CPU).encrypt(enc.encode(v)), 2)
    crs = samplers.uniform_poly(samplers.make_generator(CPU, 999), ctx.ring_q)
    ct2 = pp.refresh_mesh_dckks(dckks.RefreshProtocol(params, device=CPU, seed=8), None, sks,
                                ct, crs)
    got = enc.decode(ckks.Decryptor(params, sk_col, device=CPU).decrypt(ct2))
    return (ct2.level, params.max_level, precision_stats(got, v).median_bits,
            [_np(p) for p in ct2.value])


def _ckg_rank(sks, crp, seed, jax_draws):
    """``collective_keygen_mesh`` of the carried keys and CRP; with
    ``jax_draws``, the port's Gaussian sampler returns rank r's JAX draw."""
    params = bfv.Parameters(**SPEC).gen_from_log_moduli()
    ckg = dbfv.CKGProtocol(params, device=CPU, seed=seed)
    sks = [tu.from_u64(s, CPU) for s in sks]
    real = samplers.gaussian_poly
    if jax_draws is not None:
        draw = tu.from_u64(jax_draws[dist.get_rank()], CPU)
        samplers.gaussian_poly = lambda gen, ring, *a, **k: draw
    try:
        return _np(pp.collective_keygen_mesh(ckg, sks, tu.from_u64(crp, CPU)))
    finally:
        samplers.gaussian_poly = real


@pytest.fixture(scope="module")
def world():
    with World(N_PARTIES, device_type="cpu") as w:
        yield w


@pytest.fixture(scope="module")
def bfv_runs(world):
    return world.run(_bfv_protocols_rank)


@pytest.mark.parametrize("name", ["ckg", "cks", "pcks", "rkg", "rtg", "refresh"])
def test_mesh_protocol_decrypts_exactly(bfv_runs, name):
    for out, _ in bfv_runs:
        got, want = out[name]
        np.testing.assert_array_equal(got, want)


def test_combined_shares_equal_on_every_rank(bfv_runs):
    first = bfv_runs[0][1]
    for _, made in bfv_runs[1:]:
        assert made.keys() == first.keys()
        for k in first:
            for a, b in zip(made[k], first[k]):
                np.testing.assert_array_equal(a, b)


def test_refresh_mesh_dckks(world):
    runs = world.run(_dckks_refresh_rank)
    for level, top, bits, polys in runs:
        assert level == top
        assert bits >= 10.0
        for a, b in zip(polys, runs[0][3]):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def jax_ckg():
    """Parties' keys, a CRP made by the JAX package, and the JAX
    ``collective_keygen_mesh`` on a 4-party mesh with its Gaussian draws."""
    params = jbfv.Parameters(**SPEC).gen_from_log_moduli()
    ctx = jbfv.get_context(params)
    # the port's secret keys, carried (the JAX key generator is slow eagerly)
    _, tsks, _ = _keys(bfv.Parameters(**SPEC).gen_from_log_moduli(), bfv, 50)
    sks = [ju.from_u64(_np(s)) for s in tsks]
    crpg = JCRP(b"meshtest", ctx.ring_qp)
    crpg.seed(b"s")
    crp = crpg.clock_poly()
    ckg = jdbfv.CKGProtocol(params, rng_key=jax.random.key(1))
    # its draws: fold_in(_next_key(), p) for p in turn, _next_key = fold_in(key, n + 1)
    draws = [ju.to_u64(jsamplers.gaussian_poly(
        jax.random.fold_in(jax.random.fold_in(ckg._key, ckg._n_used + 1 + p), p),
        ctx.ring_qp, params.sigma)) for p in range(N_PARTIES)]
    out = jpp.collective_keygen_mesh(ckg, sks, crp, jax_mesh(8, party=N_PARTIES))
    return [ju.to_u64(s) for s in sks], ju.to_u64(crp), draws, ju.to_u64(out)


def test_collective_keygen_mesh_equals_jax_with_its_draws(world, jax_ckg):
    sks, crp, draws, want = jax_ckg
    for got in world.run(_ckg_rank, sks, crp, 1, draws):
        np.testing.assert_array_equal(got, want)


def test_collective_keygen_mesh_equals_sequential_fold(world, jax_ckg):
    """The same shares made one party after another in one process, each
    from the generator ``party_seed(seed, run 0, party)``, and folded."""
    sks, crp, _, _ = jax_ckg
    params = bfv.Parameters(**SPEC).gen_from_log_moduli()
    ckg = dbfv.CKGProtocol(params, device=CPU, seed=7)
    shares = []
    for p, sk in enumerate(sks):
        with ckg.using_generator(samplers.make_generator(CPU, pp.party_seed(7, 0, p))):
            shares.append(ckg.gen_share(tu.from_u64(sk, CPU), tu.from_u64(crp, CPU)))
    want = shares[0]
    for s in shares[1:]:
        want = ckg.aggregate(want, s)
    for got in world.run(_ckg_rank, sks, crp, 7, None):
        np.testing.assert_array_equal(got, _np(want))
