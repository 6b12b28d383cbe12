"""Key-switch decompositions a request: the ``ckks.decompositions`` the
program's replays count (the linear transform counts one a decomposition
it issues, one for all its hoisted rotations, while a capture runs) over
its replays.  Nothing where the program has no recorder or counts no
decomposition."""

from lattigo_tpu_torch.utils import profiling


def read(r):
    if not hasattr(profiling, "counters"):
        return None
    c = profiling.counters(replayed=True)
    decompositions, replays = c.get("ckks.decompositions", 0), c.get("tjit.replays", 0)
    return decompositions / replays if decompositions and replays else None
