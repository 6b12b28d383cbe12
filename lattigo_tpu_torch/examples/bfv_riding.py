"""Oblivious ride hailing: encrypted squared distances between one rider and
many taxis (examples/bfv/examples_bfv.go).

The twin of ``examples/bfv_riding.py``.  Run (on the GPU; ``cpu`` as a
second argument runs it on the CPU):

    python -m lattigo_tpu_torch.examples.bfv_riding [log_n] [cpu]
"""

from __future__ import annotations

import sys
import time

import numpy as np

from lattigo_tpu_torch.models import bfv


def ride(log_n: int = 8, device=None) -> dict:
    """N/2 taxis and one rider at integer positions in [0, 128)^2: the
    rider's and the taxis' coordinates encrypted, (rider - taxi)^2 per
    coordinate computed under encryption, decrypted and summed per taxi.
    Returns ``ok`` (every distance exact), the closest taxi, and the
    seconds of key generation and of the encrypted pipeline."""
    params = bfv.Parameters(
        log_n=log_n, t=65537, log_qi=(46, 46), log_pi=(47,), log_qi_mul=(60, 60)
    ).gen_from_log_moduli()
    n_taxis = params.n // 2

    t0 = time.perf_counter()
    kgen = bfv.KeyGenerator(params, device=device)
    sk, pk = kgen.gen_key_pair()
    rlk = kgen.gen_relin_key(sk, 1)
    enc = bfv.Encoder(params, device=device)
    encryptor = bfv.Encryptor(params, pk=pk, device=device)
    dec = bfv.Decryptor(params, sk, device=device)
    ev = bfv.Evaluator(params, device=device)
    keygen_s = time.perf_counter() - t0

    rng = np.random.default_rng(0)
    rider = rng.integers(0, 128, 2)
    taxis = rng.integers(0, 128, (n_taxis, 2))
    rider_slots = np.tile(rider, n_taxis).astype(np.uint64)
    taxi_slots = taxis.reshape(-1).astype(np.uint64)

    t0 = time.perf_counter()
    ct_rider = encryptor.encrypt(enc.encode_uint(rider_slots))
    ct_taxis = encryptor.encrypt(enc.encode_uint(taxi_slots))
    diff = ev.sub(ct_rider, ct_taxis)
    dist2 = ev.relinearize(ev.mul(diff, diff), rlk)
    out = enc.decode_uint(dec.decrypt(dist2))  # a host copy: the pipeline has ended
    pipeline_s = time.perf_counter() - t0

    d2 = out[0::2] + out[1::2]
    want = ((taxis - rider) ** 2).sum(axis=1)
    closest = int(np.argmin(d2))
    return dict(ok=bool((d2 == want % params.t).all()), n_taxis=n_taxis, closest=closest,
                closest_d2=int(d2[closest]), seconds=dict(keygen=keygen_s, pipeline=pipeline_s))


def main(log_n: int = 8, device=None) -> bool:
    r = ride(log_n, device)
    print(f"{r['n_taxis']} taxis, encrypted pipeline {r['seconds']['pipeline']:.1f}s; "
          f"closest taxi = #{r['closest']} at d^2 = {r['closest_d2']}; correct: {r['ok']}")
    return r["ok"]


if __name__ == "__main__":
    if not main(int(sys.argv[1]) if len(sys.argv) > 1 else 8,
                sys.argv[2] if len(sys.argv) > 2 else None):
        sys.exit(1)
