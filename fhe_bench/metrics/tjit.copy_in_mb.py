"""The bytes a program replay copies in, in MB: the program's copy-in bytes
counted each replay over its replays (the recorder's replayed counters).
Nothing where the program has no recorder."""

from lattigo_tpu_torch.utils import profiling


def read(r):
    if not hasattr(profiling, "counters"):
        return None
    c = profiling.counters(replayed=True)
    replays = c.get("tjit.replays", 0)
    return c.get("tjit.copy_in_bytes", 0) / replays / 1e6 if replays else None
