"""Multi-rank scaling harness: batched CKKS ciphertext multiplication split
over the ranks of a data group (BASELINE.json's weak-scaling metric).

Counterpart of ``lattigo_tpu/parallel/scaling.py``.  Evaluation over
independent ciphertexts is embarrassingly parallel (the reference fans it
out to goroutines, examples/dbfv/pir/pir.go:293-331); here every rank of
the group runs the same mul + relinearize on its slice of the batch, with
replicated keys.  Scaling efficiency is then
  eff(n) = throughput(n ranks) / (n * throughput(1 rank)).
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from lattigo_tpu_torch import device as _device
from lattigo_tpu_torch.models import ckks


def build_mul_step(params, rlk, device=None):
    """Batched ct-ct multiply + relinearize: takes stacked degree-1
    ciphertext polys [B, ...] and returns the relinearized product's."""
    ev = ckks.Evaluator(params, device=device)

    def step(a0, a1, b0, b1, scale_a: float, scale_b: float):
        out = ev.mul_relin(ckks.Ciphertext([a0, a1], scale_a), ckks.Ciphertext([b0, b1], scale_b), rlk)
        return out.value[0], out.value[1]

    return step


def make_ct_batch(params, encryptor, encoder, batch: int, rng):
    """``batch`` fresh degree-1 ciphertexts of uniform [-1, 1) slots, their
    polys stacked on a leading axis: (c0, c1, scale)."""
    cts = [encryptor.encrypt(encoder.encode(rng.uniform(-1, 1, params.slots).astype(np.complex128)))
           for _ in range(batch)]
    return (torch.stack([ct.value[0] for ct in cts]), torch.stack([ct.value[1] for ct in cts]),
            cts[0].scale)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def weak_scaling_mul(params, group=None, batch_per_device: int = 4, iters: int = 10,
                     rng_seed: int = 0, device=None) -> dict[int, float]:
    """Batched CKKS ct-ct mul + relinearize throughput on one rank and on
    every rank of ``group`` (None: the world), ``batch_per_device``
    ciphertext pairs a rank.  Every rank of the group calls it.

    Returns ``{n: ciphertext multiplications per second}`` for n = 1 (rank
    0 of the group alone, the others waiting) and n = the group's size:
    ``iters`` steps timed on the host clock from a barrier to a barrier
    after each rank's last ``torch.cuda.synchronize()``, after one warm-up
    step.  Keys and the batch are made alike on every rank from seeds, and
    each rank takes its slice.  Ranks that share one card measure the
    card's throughput, not scaling."""
    dev = _device.resolve(device)
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    kgen = ckks.KeyGenerator(params, device=dev, seed=rng_seed)
    sk, pk = kgen.gen_key_pair()
    rlk = kgen.gen_relin_key(sk)
    enc = ckks.Encoder(params, device=dev)
    encryptor = ckks.Encryptor(params, pk=pk, device=dev, seed=rng_seed)
    rng = np.random.default_rng(rng_seed)
    step = build_mul_step(params, rlk, device=dev)

    results = {}
    for n in sorted({1, size}):
        B = batch_per_device * n
        a0, a1, scale = make_ct_batch(params, encryptor, enc, B, rng)
        b0, b1, _ = make_ct_batch(params, encryptor, enc, B, rng)
        i = rank if n > 1 else 0
        args = [t[i * batch_per_device : (i + 1) * batch_per_device] for t in (a0, a1, b0, b1)]
        active = n > 1 or rank == 0
        if active:
            step(*args, scale, scale)
            _sync(dev)
        dist.barrier(group=group)
        t0 = time.perf_counter()
        if active:
            for _ in range(iters):
                step(*args, scale, scale)
            _sync(dev)
        dist.barrier(group=group)
        results[n] = B * iters / (time.perf_counter() - t0)
    return results
