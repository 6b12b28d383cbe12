"""The port's (party, data) mesh, its share aggregation and its launcher,
on a world of 2 gloo ranks on the CPU for the whole module.

* ``make_mesh`` lays ranks out as the JAX package's ``make_mesh`` lays
  devices (rank p * data + d at (p, d); party = 2 for an even count);
  ``shard_batch`` gives each rank its slice.
* ``aggregate_mod`` and ``mesh_aggregate`` of shares in the JAX
  package's format (uniform residues from a numpy seed; JAX protocols'
  share generators compile too slowly eagerly on this CPU) equal the JAX
  protocols' own ``aggregate`` fold, bit for bit (integers, tolerance 0):
  a poly share (CKG) and pair shares (PCKS; RKG round two, stacked).
* ``weak_scaling_mul`` runs on both ranks at a log N = 8 CKKS set.
* The PIR cloud step of examples/dbfv_pir.py with its 8 rows sharded over
  the two ranks (``DbfvPir.sharded_cloud``, 4 rows a rank), on inputs the
  JAX package makes (3 parties' keys from ``jax.random.key(i)``, the
  collective keys, the encrypted rows and query, the masks; carried over
  with ``convert``): every rank's result equals the JAX example's cloud
  and the port's unsharded ``cloud`` bit for bit, and decrypts after CKS to
  the wanted row; ``DbfvPir.run(world)`` and the example twin shard over
  the world; the example's shard rule.
* A rank that raises makes ``World.run`` raise, with its traceback; an
  unknown or unfit backend raises before any rank starts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from lattigo_tpu.models import bfv as jbfv
from lattigo_tpu.models import dbfv as jdbfv
from lattigo_tpu.ops import u64 as ju
from lattigo_tpu.parallel.mesh import make_mesh as jax_mesh
from lattigo_tpu.utils.prng import CRPGenerator as JCRP
from lattigo_tpu_torch import convert
from lattigo_tpu_torch.entry import DbfvPir
from lattigo_tpu_torch.examples import dbfv_pir
from lattigo_tpu_torch.models import bfv, ckks, dbfv
from lattigo_tpu_torch.ops import u64 as tu
from lattigo_tpu_torch.parallel import launch, mesh, protocols, scaling
from lattigo_tpu_torch.parallel.launch import World

torch.set_num_threads(1)

RANKS = 2
SPEC = dict(log_n=8, t=65537, log_qi=(46, 46), log_pi=(47,), log_qi_mul=(60, 60))
CKKS_SPEC = dict(log_n=8, log_slots=7, scale=float(1 << 32), log_qi=(45, 32, 32, 32),
                 log_pi=(45,))


def _mesh_rank(party):
    m = mesh.make_mesh(party=party, device_type="cpu")
    batch = torch.arange(8).reshape(4, 2)
    return (m.shape, m.coords, {a: dist.get_world_size(m.group(a)) for a in ("party", "data")},
            str(m.device), mesh.shard_batch(m, (batch, [batch]))[1][0].tolist())


def _aggregate_rank(shares, kind):
    """Rank r's share of each party's, aggregated over the world."""
    params = bfv.Parameters(**SPEC).gen_from_log_moduli()
    mine = shares[dist.get_rank()]
    if kind == "ckg":
        out = mesh.aggregate_mod(bfv.get_context(params, "cpu").ring_qp, tu.from_u64(mine, "cpu"))
        return tu.to_u64(out)
    proto = (dbfv.PCKSProtocol if kind == "pcks" else dbfv.RKGProtocol)(params, device="cpu")
    out = protocols.mesh_aggregate(proto, tuple(tu.from_u64(p, "cpu") for p in mine))
    return tuple(tu.to_u64(p) for p in out)


def _scaling_rank():
    return scaling.weak_scaling_mul(ckks.Parameters(**CKKS_SPEC).gen_from_log_moduli(),
                                    batch_per_device=2, iters=2, device="cpu")


def _raise_on_rank_1():
    if dist.get_rank() == 1:
        raise ValueError("party 1 refuses")
    dist.barrier()  # rank 0 waits in a collective, as ranks do when a peer fails


@pytest.fixture(scope="module")
def world():
    with World(RANKS, device_type="cpu") as w:
        yield w


def test_make_mesh_lays_out_ranks_as_the_jax_mesh(world):
    """Rank p * data + d sits at (p, d), as device p * data + d does in the
    JAX mesh over the first devices."""
    for party in (None, 1):
        jm = jax_mesh(RANKS, party=party)
        for r, (shape, coords, sizes, dev, rows) in enumerate(world.run(_mesh_rank, party)):
            assert shape == dict(jm.shape) == sizes
            assert jm.devices[coords["party"], coords["data"]] == jax.devices()[r]
            assert dev == "cpu"
            d = shape["data"]
            want = np.arange(8).reshape(4, 2)[coords["data"] * 4 // d : (coords["data"] + 1) * 4 // d]
            assert rows == want.tolist()


def _uniform(moduli, shape, rng):
    x = np.empty((*shape, len(moduli), 1 << SPEC["log_n"]), dtype=np.uint64)
    for i, q in enumerate(moduli):
        x[..., i, :] = rng.integers(0, q, size=(*shape, x.shape[-1]), dtype=np.uint64)
    return x


@pytest.fixture(scope="module")
def jax_protocols():
    params = jbfv.Parameters(**SPEC).gen_from_log_moduli()
    return params, {k: cls(params) for k, cls in (("ckg", jdbfv.CKGProtocol),
                                                    ("pcks", jdbfv.PCKSProtocol),
                                                    ("rkg", jdbfv.RKGProtocol))}


@pytest.mark.parametrize("kind", ["ckg", "pcks", "rkg"])
def test_aggregation_equals_the_jax_fold(world, jax_protocols, kind):
    params, protos = jax_protocols
    qp = list(params.qi) + list(params.pi)
    rng = np.random.default_rng({"ckg": 1, "pcks": 2, "rkg": 3}[kind])
    if kind == "ckg":
        shares = [_uniform(qp, (), rng) for _ in range(RANKS)]
        carry = ju.from_u64
    elif kind == "pcks":
        shares = [tuple(_uniform(list(params.qi), (), rng) for _ in range(2)) for _ in range(RANKS)]
        carry = lambda s: tuple(ju.from_u64(p) for p in s)
    else:
        beta = params.beta
        shares = [tuple(_uniform(qp, (beta,), rng) for _ in range(2)) for _ in range(RANKS)]
        carry = lambda s: tuple((ju.from_u64(p)[0], ju.from_u64(p)[1]) for p in s)
    acc = carry(shares[0])
    for s in shares[1:]:
        acc = protos[kind].aggregate(acc, carry(s))
    if kind == "ckg":
        want = [ju.to_u64(acc)]
    else:
        want = [ju.to_u64(p) for p in acc]
    for got in world.run(_aggregate_rank, shares, kind):
        got = [got] if kind == "ckg" else list(got)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_weak_scaling_mul_runs(world):
    for rates in world.run(_scaling_rank):
        assert sorted(rates) == [1, RANKS]
        assert all(np.isfinite(r) and r > 0 for r in rates.values())


PIR_PARTIES, PIR_ROWS = 3, 8


@pytest.fixture(scope="module")
def jax_pir():
    """examples/dbfv_pir.py:58-142 at the log N = 8 set: the parties' keys,
    the collective keys, the encrypted rows and query and the masks, as
    host arrays in ``convert``'s formats; and its cloud step (:159-178, a
    closure of its ``main``, copied below) on them.  The rows stay
    unsharded: a sharded eager call computes the same bits, at twice the
    compile time.  Its relinearization is one ``jax.jit`` call, the rest
    runs eagerly as the example runs it on the CPU; the bits are the same
    either way, and the eager relinearization compiles its primitives one
    by one, several times slower."""
    params = jbfv.Parameters(**SPEC).gen_from_log_moduli()
    ctx = jbfv.get_context(params)
    sks = [jbfv.KeyGenerator(params, rng_key=jax.random.key(i)).gen_secret_key()
           for i in range(PIR_PARTIES)]
    crp_gen = JCRP(b"pir", ctx.ring_qp)
    crp_gen.seed(b"common-seed")

    def stacked_crp(beta):
        polys = [crp_gen.clock_poly() for _ in range(beta)]
        return jnp.stack([p[0] for p in polys]), jnp.stack([p[1] for p in polys])

    def fold(proto, shares):
        acc = shares[0]
        for sh in shares[1:]:
            acc = proto.aggregate(acc, sh)
        return acc

    ckg = jdbfv.CKGProtocol(params)
    crp = crp_gen.clock_poly()
    pk = ckg.gen_public_key(fold(ckg, [ckg.gen_share(sk.sk, crp) for sk in sks]), crp)
    rkg = jdbfv.RKGProtocol(params)
    crp_rkg = stacked_crp(params.beta)
    ephs = [rkg.new_ephemeral_key() for _ in sks]
    r1 = fold(rkg, [rkg.gen_share_round_one(e, sk.sk, crp_rkg) for e, sk in zip(ephs, sks)])
    r2 = fold(rkg, [rkg.gen_share_round_two(r1, sk.sk, crp_rkg) for sk in sks])
    r3 = fold(rkg, [rkg.gen_share_round_three(r2, e, sk.sk) for e, sk in zip(ephs, sks)])
    rlk = rkg.gen_relinearization_key(r2, r3)
    rtg = jdbfv.RTGProtocol(params)
    rot_keys = jbfv.RotationKeys()
    for rot_type, k in [("left", 1 << i) for i in range(params.log_n - 1)] + [("row", 0)]:
        crp_rot = stacked_crp(params.beta)
        shares = [rtg.gen_share(rot_type, k, sk.sk, crp_rot) for sk in sks]
        rtg.finalize(rot_type, k, fold(rtg, shares), crp_rot, rot_keys)

    enc = jbfv.Encoder(params)
    encryptor = jbfv.Encryptor(params, pk=pk)
    rng = np.random.default_rng(0)
    rows = [rng.integers(0, 256, params.n, dtype=np.uint64) for _ in range(PIR_ROWS)]
    query = np.zeros(params.n, dtype=np.uint64)
    query[DbfvPir.wanted] = 1
    ct_rows = [encryptor.encrypt(enc.encode_uint(r)) for r in rows]
    ct_query = encryptor.encrypt(enc.encode_uint(query))
    stack = lambda ps: (jnp.stack([p[0] for p in ps]), jnp.stack([p[1] for p in ps]))
    rows_c0 = stack([ct.value[0] for ct in ct_rows])
    rows_c1 = stack([ct.value[1] for ct in ct_rows])
    masks = []
    for r in range(PIR_ROWS):
        mask = np.zeros(params.n, dtype=np.uint64)
        mask[r] = 1
        masks.append(enc.encode_uint(mask).value)
    masks_s = stack(masks)

    ev = jbfv.Evaluator(params)
    relinearize = jax.jit(ev.relinearize)

    def cloud(q_ct, r0, r1, m, rk, rot):
        R = r0[0].shape[0]
        bq0 = (jnp.broadcast_to(q_ct.value[0][0][None], r0[0].shape),
               jnp.broadcast_to(q_ct.value[0][1][None], r0[1].shape))
        bq1 = (jnp.broadcast_to(q_ct.value[1][0][None], r0[0].shape),
               jnp.broadcast_to(q_ct.value[1][1][None], r0[1].shape))
        sel = ev.mul(jbfv.Ciphertext([bq0, bq1]), jbfv.Plaintext(m))
        sel = ev.inner_sum(sel, rot)
        part = ev.mul(sel, jbfv.Ciphertext([r0, r1]))  # degree-2 batch [R,...]
        # log-depth modular tree fold over the row axis
        vals = part.value
        while R > 1:
            half = R // 2
            vals = [ctx.ring_q.add((v[0][:half], v[1][:half]), (v[0][half:], v[1][half:]))
                    for v in vals]
            R = half
        acc = jbfv.Ciphertext([(v[0][0], v[1][0]) for v in vals])
        return relinearize(acc, rk)

    result = cloud(ct_query, rows_c0, rows_c1, masks_s, rlk, rot_keys)
    swk = lambda k: (ju.to_u64(k.key0), ju.to_u64(k.key1))
    return dict(
        sks=[ju.to_u64(sk.sk) for sk in sks], rows=rows,
        query=[ju.to_u64(p) for p in ct_query.value],
        ct_rows=[ju.to_u64(rows_c0), ju.to_u64(rows_c1)], masks=ju.to_u64(masks_s),
        rlk=swk(rlk.evakey[0]),
        rot_keys=({k: swk(v) for k, v in rot_keys.left.items()}, {}, swk(rot_keys.row)),
        result=[ju.to_u64(p) for p in result.value])


@pytest.fixture(scope="module")
def port_pir(world, jax_pir):
    """The JAX package's inputs carried into the port (``convert``), the
    port's unsharded ``cloud`` on them and its cloud sharded over the
    world's two ranks."""
    pir = DbfvPir(bfv.Parameters(**SPEC).gen_from_log_moduli(), "cpu", PIR_PARTIES, PIR_ROWS)
    args = (convert.ciphertext_from_numpy(jax_pir["query"], "cpu"),
            convert.ciphertext_from_numpy(jax_pir["ct_rows"], "cpu"),
            convert.poly_from_numpy(jax_pir["masks"], "cpu"),
            bfv.EvaluationKey([convert.switching_key_from_numpy(*jax_pir["rlk"], "cpu")]),
            convert.bfv_rotation_keys_from_numpy(*jax_pir["rot_keys"], "cpu"))
    return dict(pir=pir, unsharded=pir.cloud(*args),
                sharded=pir.sharded_cloud(world, *args, calls=2))


def test_sharded_pir_cloud_equals_the_jax_example(jax_pir, port_pir):
    for rank in port_pir["sharded"]["ranks"]:
        assert len(rank["result"]) == len(jax_pir["result"]) == 2
        for got, want in zip(rank["result"], jax_pir["result"]):
            np.testing.assert_array_equal(got, want)


def test_sharded_pir_cloud_equals_the_unsharded_cloud(port_pir):
    """Bit for bit, on both ranks: every partial sum and the fold across
    the ranks are canonical residues, so the order of the adds does not
    show.  Each rank summed 4 rows (its stacked transforms lead with 4)
    and timed each stage of both calls."""
    want = convert.ciphertext_to_numpy(port_pir["unsharded"])
    sharded = port_pir["sharded"]
    for got, w in zip(convert.ciphertext_to_numpy(sharded["result"]), want):
        np.testing.assert_array_equal(got, w)
    for rank in sharded["ranks"]:
        for got, w in zip(rank["result"], want):
            np.testing.assert_array_equal(got, w)
        assert rank["rows"] == PIR_ROWS // RANKS and rank["peak_bytes"] is None
        assert [len(v) for v in rank["seconds"].values()] == [2, 2, 2]
        assert {t[1][0] for t in rank["transforms"] if len(t[1]) == 3} >= {PIR_ROWS // RANKS}


def test_sharded_pir_retrieves_the_wanted_row(world, jax_pir, port_pir):
    """The sharded result of the JAX inputs, switched (CKS) from the JAX
    parties' keys to a requester's; and ``DbfvPir.run(world)`` in the port
    alone."""
    pir = port_pir["pir"]
    pir.sks = [convert.secret_key_from_numpy(sk, "cpu") for sk in jax_pir["sks"]]
    sk_req = pir.requester_key()
    got = pir.decrypt(pir.cks(port_pir["sharded"]["result"], sk_req), sk_req)
    np.testing.assert_array_equal(got, jax_pir["rows"][DbfvPir.wanted])
    own = DbfvPir(bfv.Parameters(**SPEC).gen_from_log_moduli(), "cpu", PIR_PARTIES, PIR_ROWS)
    np.testing.assert_array_equal(own.run(world), own.rows[own.wanted])
    assert own.compiled_cloud.trace_count() == 0  # no unsharded cloud ran


@pytest.mark.parametrize("n_rows, count, sharded", [
    (8, 2, True), (8, 4, True), (8, 8, True), (64, 4, True),
    (8, 1, False), (8, 3, False), (8, 16, False), (8, 0, False)])
def test_pir_shard_rule_is_the_jax_examples(n_rows, count, sharded):
    """examples/dbfv_pir.py:146: several devices that split the rows."""
    assert dbfv_pir.shards(n_rows, count) is sharded


def test_pir_example_shards_over_a_given_world(world, capsys):
    assert dbfv_pir.main(PIR_PARTIES, 8, device="cpu", world=world) is True
    assert "[cloud]   row axis sharded over 2 ranks" in capsys.readouterr().out
    r = dbfv_pir.retrieve(PIR_PARTIES, 8, device="cpu", n_rows=4, world=world)
    assert r["ok"] and r["ranks"] == RANKS and r["compiled_programs"] == 0


def test_backend_is_checked_before_any_rank_starts():
    with pytest.raises(ValueError, match="one card a rank"):
        launch.World(RANKS, backend="nccl", device_type="cuda")
    with pytest.raises(ValueError, match="needs CUDA"):
        launch.World(RANKS, backend="nccl", device_type="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        launch.World(RANKS, backend="mpi", device_type="cpu")


def test_no_device_means_the_card(monkeypatch):
    """``device_type=None`` means CUDA: without a GPU the world raises
    before any rank is spawned, and nothing falls back to CPU ranks."""
    import multiprocessing

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = set(multiprocessing.active_children())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.World(RANKS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.run(RANKS, _raise_on_rank_1)
    assert set(multiprocessing.active_children()) == before


def test_a_rank_that_raises_fails_the_run(world):
    """Last in the module: a failure tears the world down."""
    with pytest.raises(RuntimeError, match="rank 1 of 2 raised(.|\n)*party 1 refuses"):
        world.run(_raise_on_rank_1)
    with pytest.raises(RuntimeError, match="closed"):
        world.run(_scaling_rank)
