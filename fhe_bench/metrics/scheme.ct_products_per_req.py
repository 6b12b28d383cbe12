"""Ciphertext products a request: the ``ckks.poly.products`` the program's
replays count (the polynomial evaluator counts one a ``mul_relin`` of two
ciphertexts while a capture runs) over its replays.  Nothing where the
program has no recorder or counts no such product."""

from lattigo_tpu_torch.utils import profiling


def read(r):
    if not hasattr(profiling, "counters"):
        return None
    c = profiling.counters(replayed=True)
    products, replays = c.get("ckks.poly.products", 0), c.get("tjit.replays", 0)
    return products / replays if products and replays else None
