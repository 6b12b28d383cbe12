"""The key switch's inner product ``sum_i key_i (.) d_i`` over the beta
decomposition blocks, both key halves in one CUDA launch
(``csrc/key_switch.cu``).

No TPU kernel: under ``jax.jit`` XLA fuses the fold of the JAX package
(``lattigo_tpu/models/ckks/evaluator.py`` ``_inner_product``, the loop in
``lattigo_tpu/models/bfv/evaluator.py`` ``_switch_keys_core``) into one
device pass.  Its plain version :func:`inner_product_plain` is that fold as
the port ran it before: one batched Montgomery product a key half, the adds
of PyTorch and a ``reduce_limbs`` whenever 7 products are pending (the
reference's lazy reduction, ckks/evaluator.go:1536); a CPU tensor takes it.

``d`` holds the blocks along ``beta_axis`` (BFV: 0, ``[beta, ..., L, N]``;
CKKS: -3, ``[..., beta, L, N]``).  Output limb ``l`` lives under the ring
table row ``limbs[l]``; the key keeps every limb of the ring in its order,
so it reads row ``limbs[l]`` of ``key[:beta]`` too (no key planes are
copied).
``index`` is an NTT-domain permutation of the coefficients
(``galois.ntt_index``): the blocks are read through it instead of being
permuted first.  The result is one new ``[2, ..., L, N]`` tensor, the two
key halves.

Bound on the GPU: the bytes (``d`` read once, both key halves and the map
once, both outputs written once).  Which calls launch, and the launch
itself, are ``_build``'s, as for the other modular kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from lattigo_tpu_torch import _build
from lattigo_tpu_torch.ops import modred_kernel as mk
from lattigo_tpu_torch.utils import profiling

T = torch.Tensor
PENDING = 7  # products summed before a reduction (csrc/key_switch.cu PENDING)


def _key_rows(key: T, beta: int, limbs, ring) -> T:
    """Rows ``limbs`` of the first ``beta`` blocks of a key half: a slice
    for a prefix, else a gather through the ring's cached index vector."""
    k = key[:beta]
    if tuple(limbs) == tuple(range(len(limbs))):
        return k[:, : len(limbs)]
    return k.index_select(-2, ring.limb_vector(limbs))


def inner_product_plain(d: T, key0: T, key1: T, ring, limbs, beta: int, index: T | None = None,
                        beta_axis: int = -3) -> T:
    """The fold of both key halves over the ``beta`` blocks of ``d``, on
    the ring's modular ops (see the module's docstring)."""
    d = d.movedim(beta_axis, -3)
    if index is not None:
        d = torch.index_select(d, -1, index)

    def fold(key):
        t = ring.mul_coeffs_montgomery_limbs(_key_rows(key, beta, limbs, ring), d, limbs)
        acc = t[..., 0, :, :]
        pending = 1
        for i in range(1, beta):
            acc = acc + t[..., i, :, :]
            pending += 1
            if pending == PENDING:
                acc = ring.reduce_limbs(acc, limbs)
                pending = 1
        return ring.reduce_limbs(acc, limbs)

    return torch.stack((fold(key0), fold(key1)))


def d_plan(d: T, beta_axis: int) -> tuple[T, tuple[int, int, int, int], tuple[int, ...], int]:
    """``d`` as the kernel reads it: ``(tensor, (batch, block, limb,
    coefficient) strides, batch shape, copies)``.  The batch dims collapse
    into one stride, or ``d`` is copied once (counted) with its blocks
    moved before the limbs."""
    dv = d.movedim(beta_axis, -3)
    copies = 0
    st = mk.view_strides(dv.select(-3, 0), dv.shape[:-3] + dv.shape[-2:])
    if st is None:
        dv = dv.contiguous()
        copies = 1
        st = mk.view_strides(dv.select(-3, 0), dv.shape[:-3] + dv.shape[-2:])
    sb, sl, sn = st
    return dv, (sb, dv.stride(-3) if dv.shape[-3] != 1 else 0, sl, sn), dv.shape[:-3], copies


def inner_product(d: T, key0: T, key1: T, ring, limbs, beta: int, index: T | None = None,
                  beta_axis: int = -3) -> T:
    """:func:`inner_product_plain` as one launch of ``csrc/key_switch.cu``
    for CUDA tensors; the plain version for CPU tensors."""
    operands = (d, key0, key1, ring.q_) + (() if index is None else (index,))
    if not _build.takes_kernel("key_switch", *operands):
        return inner_product_plain(d, key0, key1, ring, limbs, beta, index, beta_axis)
    return _inner_product_kernel(d, key0, key1, ring, limbs, beta, index, beta_axis)


@profiling.timed("kernel.key_switch")
def _inner_product_kernel(d: T, key0: T, key1: T, ring, limbs, beta: int, index: T | None,
                          beta_axis: int) -> T:
    """:func:`inner_product`'s launch (its host side is the span
    ``kernel.key_switch``)."""
    limbs = tuple(limbs)
    n = d.shape[-1]
    if d.shape[beta_axis] != beta or d.shape[-2] != len(limbs):
        raise ValueError(f"d {tuple(d.shape)} holds no {beta} blocks along {beta_axis} of "
                         f"{len(limbs)} limbs")
    if max(limbs) >= ring.L or min(limbs) < 0:
        raise ValueError(f"limbs {limbs} out of range for a ring of {ring.L}")
    if key0.ndim != 3 or key0.shape != key1.shape or key0.shape[0] < beta \
            or key0.shape[-1] != n or max(limbs) >= key0.shape[1]:
        raise ValueError(f"keys {tuple(key0.shape)} / {tuple(key1.shape)} do not hold "
                         f"{beta} blocks of rows {limbs} at N = {n}")
    if index is not None and (index.shape != (n,) or index.dtype != torch.int64):
        raise ValueError(f"index {tuple(index.shape)} {index.dtype} is no permutation of {n}")
    dv, dstr, batch, copies = d_plan(d, beta_axis)
    if key0.stride() != key1.stride():
        key0, key1 = key0.contiguous(), key1.contiguous()
        copies += 2
    out = torch.empty((2, *batch, len(limbs), n), dtype=torch.int64, device=d.device)
    if out.numel() == 0:
        return out
    dstr, kstr = np.array(dstr, dtype=np.int64), np.array(key0.stride(), dtype=np.int64)
    _build.launch("key_switch", d.device, (
        dv.data_ptr(), dstr.ctypes.data, key0.data_ptr(), key1.data_ptr(), kstr.ctypes.data,
        ring.q_.data_ptr(), ring.qinv_.data_ptr(), ring.u0_.data_ptr(),
        ring.limb_vector(limbs).data_ptr(),
        None if index is None else index.data_ptr(), out.data_ptr(),
        out.numel() // (2 * len(limbs) * n), n, len(limbs), beta,
    ), lambda: f"d {tuple(d.shape)} with {beta} blocks", copies=copies,
        record=("key_switch", (d, key0, key1), (ring, limbs, beta, beta_axis, index)))
    return out
