"""The (party, data) mesh over the ranks of a ``torch.distributed`` world.

Counterpart of ``lattigo_tpu/parallel/mesh.py``.  The framework's parallel
axes (SURVEY.md section 5):

* ``party``: threshold-protocol parties (dbfv/dckks).  Aggregation is an
  all-gather over the party group, then the modular fold in rank order
  (:func:`aggregate_mod`): a plain sum of the int64 residues would wrap.
* ``data``: independent ciphertexts (the reference's goroutine per
  ciphertext, examples/dbfv/pir/pir.go:293-331, mapped onto ranks).

One process is one rank.  The mesh is a grid of process groups: rank
``p * data + d`` sits at (p, d); its party group holds the ranks of column
d, its data group those of row p.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from lattigo_tpu_torch import device as _device


class Mesh:
    """This rank's place in the (party, data) grid and its two groups."""

    def __init__(self, shape: dict[str, int], coords: dict[str, int], groups: dict,
                 device: torch.device):
        self.shape = shape    # {"party": P, "data": D}
        self.coords = coords  # this rank's (party, data) coordinates
        self.groups = groups  # this rank's group along each axis
        self.device = device  # this rank's device

    def group(self, axis: str):
        return self.groups[axis]


def make_mesh(n_devices: int | None = None, party: int | None = None,
              device_type: str | None = None) -> Mesh:
    """The (party, data) mesh over the current world of ``n_devices`` ranks
    (None: the world's size, which it must equal).  ``party`` defaults to 2
    when the count is even and above 1, else 1, as in the JAX package.
    ``device_type`` "cuda" (the default, which raises without a GPU) puts
    rank r on ``cuda:(r % device_count)``; "cpu" on the CPU.  Every rank of
    the world must call it, in the same order as its other group calls."""
    world, rank = dist.get_world_size(), dist.get_rank()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    if party is None:
        party = 2 if n % 2 == 0 and n > 1 else 1
    if n % party:
        raise ValueError(f"{party} parties do not divide {n} ranks")
    data = n // party
    # every rank creates every group, in the same order
    party_groups = [dist.new_group([p * data + d for p in range(party)]) for d in range(data)]
    data_groups = [dist.new_group([p * data + d for d in range(data)]) for p in range(party)]
    p, d = divmod(rank, data)
    if device_type is None:
        _device.resolve(None)  # raises without a GPU
        device_type = "cuda"
    device = (torch.device("cuda", rank % torch.cuda.device_count())
              if device_type == "cuda" else torch.device(device_type))
    return Mesh({"party": party, "data": data}, {"party": p, "data": d},
                {"party": party_groups[d], "data": data_groups[p]}, device)


def shard_batch(mesh: Mesh, x, axis: str = "data"):
    """This rank's slice of the leading batch dim of ``x`` (a tensor, or a
    tuple / list of them) along ``axis``."""
    size, i = mesh.shape[axis], mesh.coords[axis]
    if isinstance(x, (tuple, list)):
        return type(x)(shard_batch(mesh, e, axis) for e in x)
    if x.shape[0] % size:
        raise ValueError(f"a batch of {x.shape[0]} does not split over {size} ranks")
    b = x.shape[0] // size
    return x[i * b : (i + 1) * b]


def gather(x: torch.Tensor, group=None) -> list[torch.Tensor]:
    """Every rank's ``x`` (same shape and dtype on each) in rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


def aggregate_mod(ring, share: torch.Tensor, group=None) -> torch.Tensor:
    """The modular sum of every party's residue share: an all-gather over
    the party group (None: the world), then ``ring.add`` in rank order, so
    every rank gets the same result.  The twin of the reference's
    ``AggregateShares`` adds (e.g. dbfv/keyswitching.go:115-118); a port
    poly is one int64 tensor, so this is one gather where JAX does two."""
    parts = gather(share, group)
    acc = parts[0]
    for p in parts[1:]:
        acc = ring.add(acc, p)
    return acc
