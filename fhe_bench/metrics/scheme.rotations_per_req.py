"""Galois key switches a request: the ``ckks.rotations`` the program's
replays count (the linear transform counts one a rotation while a capture
runs) over its replays.  Nothing where the program has no recorder or
counts no rotation."""

from lattigo_tpu_torch.utils import profiling


def read(r):
    if not hasattr(profiling, "counters"):
        return None
    c = profiling.counters(replayed=True)
    rotations, replays = c.get("ckks.rotations", 0), c.get("tjit.replays", 0)
    return rotations / replays if rotations and replays else None
