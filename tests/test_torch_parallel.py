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
* A rank that raises makes ``World.run`` raise, with its traceback; an
  unknown or unfit backend raises before any rank starts."""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from lattigo_tpu.models import bfv as jbfv
from lattigo_tpu.models import dbfv as jdbfv
from lattigo_tpu.ops import u64 as ju
from lattigo_tpu.parallel.mesh import make_mesh as jax_mesh
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
