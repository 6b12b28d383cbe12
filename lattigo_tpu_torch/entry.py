"""The port's main path: a BFV encrypted multiply + relinearization (the
reference's hottest path, bfv/evaluator.go:278-464 + :736-813)."""

from __future__ import annotations

import numpy as np
import torch

from lattigo_tpu_torch.models import bfv


def entry(device=None, params_idx: int = bfv.PN12QP109, batch=()):
    """Returns ``(forward, (ct0, ct1, rlk_swk))`` at a reference-shipped BFV
    parameter set: keys are generated, ``m`` and its reverse are encrypted,
    and ``forward(ct0, ct1, rlk_swk)`` is ``relinearize(mul(ct0, ct1))``.

    ``batch`` stacks that many independently encrypted ciphertext pairs on
    leading axes; the evaluator broadcasts over them.  ``device=None`` means
    the GPU and raises when there is none."""
    params = bfv.default_params(params_idx)
    kgen = bfv.KeyGenerator(params, device=device)
    enc = bfv.Encoder(params, device=device)
    ev = bfv.Evaluator(params, device=device)
    m = np.arange(params.n, dtype=np.uint64) % params.t

    sk, pk = kgen.gen_key_pair()
    rlk_swk = kgen.gen_relin_key(sk, 1).evakey[0]
    encryptor = bfv.Encryptor(params, pk=pk, device=device)

    def encrypt(msg) -> bfv.Ciphertext:
        count = int(np.prod(batch, dtype=np.int64)) if batch else 1
        cts = [encryptor.encrypt(enc.encode_uint(msg)) for _ in range(count)]
        if not batch:
            return cts[0]
        stack = lambda k: torch.stack([c.value[k] for c in cts]).reshape(
            *batch, *cts[0].value[k].shape)
        return bfv.Ciphertext([stack(0), stack(1)])

    ct0, ct1 = encrypt(m), encrypt(m[::-1].copy())

    def forward(ct_a: bfv.Ciphertext, ct_b: bfv.Ciphertext, swk: bfv.SwitchingKey) -> bfv.Ciphertext:
        return ev.relinearize(ev.mul(ct_a, ct_b), bfv.EvaluationKey([swk]))

    forward.secret_key = sk  # lets a caller decrypt what forward returns
    return forward, (ct0, ct1, rlk_swk)
