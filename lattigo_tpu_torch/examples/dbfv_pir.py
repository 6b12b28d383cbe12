"""N-party private information retrieval over threshold BFV
(examples/dbfv/pir/pir.go).

The twin of ``examples/dbfv_pir.py``, a thin main over ``entry.DbfvPir``:
CKG -> RKG (3 rounds) -> RTG (power-of-two rotations, the row swap) ->
encrypt 8 database rows and a one-hot query under the collective key ->
the cloud step (select, ``inner_sum``, multiply with the rows, sum,
relinearize; one ``tjit`` program on CUDA, as the JAX example compiles it
on an accelerator, eager on the CPU) -> CKS to the requester's key ->
decrypt.  Defaults: 3 parties at PN13QP218 (N = 8192); below log N = 13
the JAX example's small set (Q = 2 x 46 bit, P = 47 bit).  With more than
one card and a card count that divides the rows, the row axis is sharded
over an NCCL world of one rank a card, as the JAX example shards it over a
``data`` mesh (examples/dbfv_pir.py:146-156): each rank sums its rows, one
modular fold across the ranks follows (``DbfvPir.sharded_cloud``).  A
caller may bring its own world (``world=``: gloo ranks sharing one card, or
CPU ranks), over which the same rule shards.  Run (on the GPU; ``cpu`` as
a third argument runs it on the CPU):

    python -m lattigo_tpu_torch.examples.dbfv_pir [n_parties] [log_n] [cpu]
"""

from __future__ import annotations

import sys
import time

import torch

from lattigo_tpu_torch import _build
from lattigo_tpu_torch.entry import DbfvPir
from lattigo_tpu_torch.models import bfv
from lattigo_tpu_torch.parallel import launch


def params_for(log_n: int) -> bfv.Parameters:
    """PN13QP218 from log N = 13 on, else the JAX example's small set."""
    if log_n >= 13:
        return bfv.default_params(bfv.PN13QP218)
    return bfv.Parameters(log_n=log_n, t=65537, log_qi=(46, 46), log_pi=(47,),
                          log_qi_mul=(60, 60)).gen_from_log_moduli()


def shards(n_rows: int, count: int) -> bool:
    """The JAX example's rule (examples/dbfv_pir.py:146): the row axis is
    sharded over ``count`` devices when there are several and they split
    the rows evenly."""
    return count > 1 and n_rows % count == 0


def retrieve(n_parties: int = 3, log_n: int = 13, device=None, n_rows: int = 8,
             world: launch.World | None = None) -> dict:
    """Every stage of the PIR; returns ``ok`` (row ``DbfvPir.wanted``
    retrieved exactly), N, the ranks the cloud step was sharded over (1:
    not sharded), the programs the unsharded compiled cloud step holds (1
    on CUDA, 0 on the CPU or when sharded) and the seconds of the whole
    run.  ``world``: an open ``launch.World`` to shard over (by
    :func:`shards`); without one, an NCCL world of every card when
    :func:`shards` says so."""
    t0 = time.perf_counter()
    pir = DbfvPir(params_for(log_n), device, n_parties, n_rows)
    if world is not None:
        ranks = world.size
    else:
        ranks = torch.cuda.device_count() if pir.device.type == "cuda" else 1
    if not shards(n_rows, ranks):
        ranks = 1
        got = pir.run()
    elif world is not None:
        got = pir.run(world)
    else:
        _build.build()  # once here, not once a rank
        with launch.World(ranks, "nccl", "cuda") as own:
            got = pir.run(own)
    return dict(ok=bool((got == pir.rows[pir.wanted]).all()), n=pir.params.n,
                parties=n_parties, rows=n_rows, wanted=pir.wanted, device=str(pir.device),
                ranks=ranks, compiled_programs=pir.compiled_cloud.trace_count(),
                seconds=time.perf_counter() - t0)


def main(n_parties: int = 3, log_n: int = 13, device=None, n_rows: int = 8,
         world: launch.World | None = None) -> bool:
    r = retrieve(n_parties, log_n, device, n_rows, world)
    if r["ranks"] > 1:
        print(f"[cloud]   row axis sharded over {r['ranks']} ranks")
    print(f"[pir] N={r['n']}, {n_parties} parties, {n_rows} rows on {r['device']}, "
          f"{r['seconds']:.1f}s -> row {r['wanted']} retrieved: {r['ok']}")
    return r["ok"]


if __name__ == "__main__":
    if not main(int(sys.argv[1]) if len(sys.argv) > 1 else 3,
                int(sys.argv[2]) if len(sys.argv) > 2 else 13,
                sys.argv[3] if len(sys.argv) > 3 else None):
        sys.exit(1)
