"""CKKS scheme context (ckks/ckks.go:17-89): the rings Q, P and QP, the
Galois elements of the rotations, the basis extender and the key-switch
decomposer, with every table on one explicit device."""

from __future__ import annotations

import functools

from lattigo_tpu_torch import device as _device
from lattigo_tpu_torch.ops.basis_ext import Decomposer, FastBasisExtender
from lattigo_tpu_torch.ops.galois import gen_galois_params
from lattigo_tpu_torch.ops.ring import Ring

GALOIS_GEN = 5  # ckks/ckks.go:12


class CKKSContext:
    def __init__(self, params, device=None):
        params.gen_from_log_moduli()
        self.params = params
        self.device = dev = _device.resolve(device)
        n = params.n
        self.n = n
        self.max_slots = n >> 1
        self.scale = params.scale
        self.levels = len(params.qi)

        # partial products Q_0..Q_l (ckks/utils.go:113-122)
        self.bigint_chain = []
        acc = 1
        for q in params.qi:
            acc *= q
            self.bigint_chain.append(acc)

        self.ring_q = Ring(n, list(params.qi), device=dev)
        self.ring_p = Ring(n, list(params.pi), device=dev) if params.pi else None
        self.ring_qp = Ring(n, list(params.qi) + list(params.pi), device=dev)

        self.gal_el_rot_col_left = gen_galois_params(n, GALOIS_GEN)
        self.gal_el_rot_col_right = gen_galois_params(n, pow(GALOIS_GEN, 2 * n - 1, 2 * n))
        self.gal_el_conjugate = 2 * n - 1

    @functools.cached_property
    def basis_q_p(self) -> FastBasisExtender:
        assert self.ring_p is not None, "modulus P is empty"
        return FastBasisExtender(self.ring_q, self.ring_p)

    @functools.cached_property
    def decomposer(self) -> Decomposer:
        return Decomposer(list(self.params.qi), list(self.params.pi), self.device)


_contexts: dict = {}


def get_context(params, device=None) -> CKKSContext:
    """One shared context per (parameter set, device): contexts hold large
    device tables.  The key holds every field the context's users read from
    it: the moduli, the default scale and the noise's sigma."""
    params.gen_from_log_moduli()
    dev = _device.resolve(device)
    k = (params.log_n, params.log_slots, params.scale, params.sigma, params.qi, params.pi, str(dev))
    if k not in _contexts:
        _contexts[k] = CKKSContext(params, dev)
    return _contexts[k]
