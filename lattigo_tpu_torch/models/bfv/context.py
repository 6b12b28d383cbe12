"""BFV scheme context: the five ring contexts plus conversion machinery
(bfv/bfv.go:14-76), with every table on one explicit device."""

from __future__ import annotations

import functools

from lattigo_tpu_torch import device as _device
from lattigo_tpu_torch.ops import number_theory as nt
from lattigo_tpu_torch.ops.basis_ext import Decomposer, FastBasisExtender
from lattigo_tpu_torch.ops.galois import gen_galois_params
from lattigo_tpu_torch.ops.ring import Ring
from lattigo_tpu_torch.ops.scaling import SimpleScaler

GALOIS_GEN = 5  # bfv/bfv.go:10


class BFVContext:
    def __init__(self, params, device=None):
        params.gen_from_log_moduli()
        self.params = params
        self.device = dev = _device.resolve(device)
        n = params.n
        self.n = n
        self.ring_t = Ring(n, [params.t], device=dev)
        self.ring_q = Ring(n, list(params.qi), device=dev)
        self.ring_qmul = Ring(n, list(params.qi_mul), device=dev)
        self.ring_p = Ring(n, list(params.pi), device=dev) if params.pi else None
        self.ring_qp = Ring(n, list(params.qi) + list(params.pi), device=dev)

        self.gal_el_rot_col_left = gen_galois_params(n, GALOIS_GEN)
        self.gal_el_rot_col_right = gen_galois_params(n, pow(GALOIS_GEN, 2 * n - 1, 2 * n))
        self.gal_el_rot_row = 2 * n - 1

    @functools.cached_property
    def basis_q_qmul(self) -> FastBasisExtender:
        return FastBasisExtender(self.ring_q, self.ring_qmul)

    @functools.cached_property
    def basis_q_p(self) -> FastBasisExtender:
        assert self.ring_p is not None, "modulus P is empty"
        return FastBasisExtender(self.ring_q, self.ring_p)

    @functools.cached_property
    def decomposer(self) -> Decomposer:
        return Decomposer(list(self.params.qi), list(self.params.pi), self.device)

    @functools.cached_property
    def scaler_t(self) -> SimpleScaler:
        return SimpleScaler(self.params.t, self.ring_q)

    @functools.cached_property
    def delta_mont(self) -> list[int]:
        """MForm(floor(Q/t) mod q_i) lift constants (bfv/utils.go:9-24)."""
        delta = self.ring_q.modulus_bigint // self.params.t
        return [nt.mform(delta % q, q) for q in self.ring_q.moduli]


_contexts: dict = {}


def get_context(params, device=None) -> BFVContext:
    """One shared context per (parameter set, device): contexts hold large
    device tables."""
    params.gen_from_log_moduli()
    dev = _device.resolve(device)
    k = (params.log_n, params.t, params.qi, params.pi, params.qi_mul, str(dev))
    if k not in _contexts:
        _contexts[k] = BFVContext(params, dev)
    return _contexts[k]
