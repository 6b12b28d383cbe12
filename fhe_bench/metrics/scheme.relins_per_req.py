"""Ciphertexts relinearized a request: the ``ckks.relinearized`` the
program's replays count (the evaluator counts the stack of each
relinearization while a capture runs) over its replays.  Nothing where the
program has no recorder or counts no relinearization."""

from lattigo_tpu_torch.utils import profiling


def read(r):
    if not hasattr(profiling, "counters"):
        return None
    c = profiling.counters(replayed=True)
    relins, replays = c.get("ckks.relinearized", 0), c.get("tjit.replays", 0)
    return relins / replays if relins and replays else None
