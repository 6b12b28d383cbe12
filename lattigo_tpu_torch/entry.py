"""The port's main paths: a BFV encrypted multiply + relinearization (the
reference's hottest path, bfv/evaluator.go:278-464 + :736-813), and a CKKS
multiply + relinearize + rescale at the reference's largest set
(ckks/evaluator.go:1016-1133 + :901-995)."""

from __future__ import annotations

import numpy as np
import torch

from lattigo_tpu_torch.models import bfv, ckks


def _stack(cts: list, batch: tuple, make):
    """``cts`` (count = prod(batch)) stacked on leading axes ``batch``."""
    if not batch:
        return cts[0]
    stack = lambda k: torch.stack([c.value[k] for c in cts]).reshape(*batch, *cts[0].value[k].shape)
    return make([stack(k) for k in range(len(cts[0].value))], cts[0])


def _count(batch: tuple) -> int:
    return int(np.prod(batch, dtype=np.int64)) if batch else 1


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
        cts = [encryptor.encrypt(enc.encode_uint(msg)) for _ in range(_count(batch))]
        return _stack(cts, batch, lambda value, _: bfv.Ciphertext(value))

    ct0, ct1 = encrypt(m), encrypt(m[::-1].copy())

    def forward(ct_a: bfv.Ciphertext, ct_b: bfv.Ciphertext, swk: bfv.SwitchingKey) -> bfv.Ciphertext:
        return ev.relinearize(ev.mul(ct_a, ct_b), bfv.EvaluationKey([swk]))

    forward.secret_key = sk  # lets a caller decrypt what forward returns
    return forward, (ct0, ct1, rlk_swk)


def entry_ckks(device=None, params_idx: int = ckks.PN16QP1761, batch=()):
    """Returns ``(forward, (ct0, ct1, rlk))`` at a reference-shipped CKKS
    parameter set, the twin of ``bench_ckks_pn16`` (bench.py): a sparse
    secret (hw = 192), its public and relinearization keys and the rotation
    keys for k = 1 and for conjugation are generated; two random complex
    vectors are encoded once and encrypted ``prod(batch)`` times each,
    stacked on leading axes; ``forward(ct0, ct1, rlk)`` is
    ``rescale(mul_relin(ct0, ct1, rlk))``.

    ``forward.secret_key``, ``.rotation_keys``, ``.values`` (the two
    vectors) and ``.evaluator`` let a caller rotate, decrypt and check what
    forward returns.  ``device=None`` means the GPU and raises when there is
    none."""
    params = ckks.default_params(params_idx)
    kgen = ckks.KeyGenerator(params, device=device, seed=3)
    sk, pk = kgen.gen_key_pair_sparse(hw=192)
    rlk = kgen.gen_relin_key(sk)
    rot_keys = ckks.RotationKeys()
    kgen.gen_rot("left", sk, 1, rot_keys)
    kgen.gen_rot("conjugate", sk, 0, rot_keys)
    enc = ckks.Encoder(params, device=device)
    ev = ckks.Evaluator(params, device=device)
    encryptor = ckks.Encryptor(params, pk=pk, device=device)
    rng = np.random.default_rng(3)
    values = tuple(rng.uniform(-1, 1, params.slots) + 1j * rng.uniform(-1, 1, params.slots)
                   for _ in range(2))

    def encrypt(pt) -> ckks.Ciphertext:
        cts = [encryptor.encrypt(pt) for _ in range(_count(batch))]
        return _stack(cts, batch, lambda value, c: ckks.Ciphertext(value, c.scale))

    ct0, ct1 = (encrypt(enc.encode(v)) for v in values)

    def forward(ct_a: ckks.Ciphertext, ct_b: ckks.Ciphertext, rlk_: ckks.EvaluationKey) -> ckks.Ciphertext:
        return ev.rescale(ev.mul_relin(ct_a, ct_b, rlk_))

    forward.secret_key = sk
    forward.rotation_keys = rot_keys
    forward.values = values
    forward.evaluator = ev
    return forward, (ct0, ct1, rlk)
