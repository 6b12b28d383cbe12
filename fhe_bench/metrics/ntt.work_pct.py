"""The share of the NTT rows a replay transforms that the request needs, in
%: the rows of the cell's work file (each transform's ``rows`` x ``count``)
over the ``ntt.rows.<route>`` rows the program's replays count, a replay.
Nothing where the program has no recorder."""

from lattigo_tpu_torch.utils import profiling


def read(r):
    if r.work is None or not hasattr(profiling, "counters"):
        return None
    c = profiling.counters(replayed=True)
    rows = sum(v for k, v in c.items() if k.startswith("ntt.rows."))
    if not rows:
        return None
    need = sum(t["rows"] * t["count"] for t in r.work["transforms"])
    return 100 * need * c.get("tjit.replays", 0) / rows
