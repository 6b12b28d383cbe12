"""Encrypted sigmoid via Chebyshev approximation over CKKS
(examples/ckks/examples_ckks.go).

The twin of ``examples/ckks_sigmoid.py``: the logistic function of 2^(log N
- 1) slots, uniform in [-4, 4] from ``np.random.default_rng(1)``, as a
degree-7 Chebyshev interpolant (``evaluate_cheby_eco``) at a scale of 2^30,
Q = 45 + 5 x 30 bit, P = 45 bit.  Run (on the GPU; ``cpu`` as a second
argument runs it on the CPU):

    python -m lattigo_tpu_torch.examples.ckks_sigmoid [log_n] [cpu]
"""

from __future__ import annotations

import sys
import time

import numpy as np

from lattigo_tpu_torch.entry import sigmoid as logistic
from lattigo_tpu_torch.models import ckks
from lattigo_tpu_torch.utils.precision import precision_stats

MIN_BITS = 7.0  # the JAX example passes above this median precision


def sigmoid(log_n: int = 8, device=None) -> dict:
    """Encrypts the slots, evaluates the interpolant, decrypts.  Returns the
    inputs (``values``), the decoded outputs (``got``), the median bits
    against the sigmoid, the levels consumed and the seconds of the
    encrypted pipeline (encryption to decoding)."""
    params = ckks.Parameters(
        log_n=log_n, log_slots=log_n - 1, scale=float(1 << 30),
        log_qi=(45, 30, 30, 30, 30, 30), log_pi=(45,),
    ).gen_from_log_moduli()
    kgen = ckks.KeyGenerator(params, device=device)
    sk, pk = kgen.gen_key_pair()
    rlk = kgen.gen_relin_key(sk)
    enc = ckks.Encoder(params, device=device)
    encryptor = ckks.Encryptor(params, pk=pk, device=device)
    dec = ckks.Decryptor(params, sk, device=device)
    ev = ckks.Evaluator(params, device=device)
    values = np.random.default_rng(1).uniform(-4, 4, params.slots)

    t0 = time.perf_counter()
    ct = encryptor.encrypt(enc.encode(values.astype(np.complex128)))
    out = ckks.evaluate_cheby_eco(ev, ct, ckks.approximate(logistic, -4, 4, 7), rlk)
    got = enc.decode(dec.decrypt(out)).real  # a host copy: the pipeline has ended
    seconds = time.perf_counter() - t0
    bits = precision_stats(got, 1 / (np.exp(-values) + 1)).median_bits
    return dict(values=values, got=got, bits=bits, levels=params.max_level - out.level,
                slots=params.slots, seconds=seconds)


def main(log_n: int = 8, device=None) -> bool:
    r = sigmoid(log_n, device)
    print(f"{r['slots']} slots, degree-7 Chebyshev sigmoid in {r['seconds']:.1f}s; "
          f"{r['levels']} levels consumed; median precision {r['bits']:.1f} bits")
    return r["bits"] > MIN_BITS


if __name__ == "__main__":
    if not main(int(sys.argv[1]) if len(sys.argv) > 1 else 8,
                sys.argv[2] if len(sys.argv) > 2 else None):
        sys.exit(1)
