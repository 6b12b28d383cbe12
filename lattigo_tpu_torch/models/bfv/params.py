"""BFV parameter sets (bfv/params.go).

Parameters carry the plaintext modulus T, the ciphertext chain Qi, the
key-switch special primes Pi and the secondary tensoring basis QiMul.  Prime
synthesis follows bfv/utils.go:27-85 (GenModuli): primes of each bit size are
drawn from one shared pool in the order Qi, Pi, QiMul, so the generated
moduli match the reference's exactly.
"""

from __future__ import annotations

import dataclasses

from lattigo_tpu_torch.ops import number_theory as nt


@dataclasses.dataclass
class Parameters:
    log_n: int
    t: int
    log_qi: tuple[int, ...] = ()
    log_pi: tuple[int, ...] = ()
    log_qi_mul: tuple[int, ...] = ()
    sigma: float = 3.2
    qi: tuple[int, ...] = ()
    pi: tuple[int, ...] = ()
    qi_mul: tuple[int, ...] = ()

    @property
    def n(self) -> int:
        return 1 << self.log_n

    @property
    def alpha(self) -> int:
        return len(self.pi)

    @property
    def beta(self) -> int:
        if not self.pi:
            return 0
        return -(-len(self.qi) // self.alpha)

    def gen_from_log_moduli(self) -> "Parameters":
        """bfv/utils.go:27-85 — shared per-bitsize prime pools."""
        if self.qi:
            return self
        sizes: dict[int, int] = {}
        for b in (*self.log_qi, *self.log_pi, *self.log_qi_mul):
            if b > 60:
                raise ValueError("moduli bit-size must be <= 60")
            sizes[b] = sizes.get(b, 0) + 1
        pools = {b: nt.generate_ntt_primes(b, self.log_n, cnt) for b, cnt in sizes.items()}
        take = lambda b: pools[b].pop(0)
        self.qi = tuple(take(b) for b in self.log_qi)
        self.pi = tuple(take(b) for b in self.log_pi)
        self.qi_mul = tuple(take(b) for b in self.log_qi_mul)
        self._validate()
        return self

    def _validate(self):
        """bfv/params.go:375-428 — NTT-compliance of every modulus."""
        two_n = 2 << self.log_n
        seen = set()
        for q in (*self.qi, *self.pi, *self.qi_mul):
            if q in seen:
                raise ValueError(f"duplicate modulus {q}")
            seen.add(q)
            if not nt.is_prime(q) or q % two_n != 1:
                raise ValueError(f"modulus {q} is not an NTT prime for N=2^{self.log_n}")

    def copy(self) -> "Parameters":
        return dataclasses.replace(self)


def _p(log_n, t, log_qi, log_pi, log_qi_mul):
    return Parameters(
        log_n=log_n, t=t, log_qi=log_qi, log_pi=log_pi, log_qi_mul=log_qi_mul
    ).gen_from_log_moduli()


# Default 128-bit-secure sets (bfv/params.go:47-88).
PN12QP109 = 0
PN13QP218 = 1
PN14QP438 = 2
PN15QP880 = 3


def default_params(idx: int) -> Parameters:
    specs = [
        (12, 65537, (39, 39), (30,), (60, 60)),
        (13, 65537, (54, 54, 54), (55,), (60, 60, 60)),
        (14, 65537, (56, 55, 55, 54, 54, 54), (55, 55), (60,) * 6),
        (15, 65537, (59, 59, 59) + (58,) * 9, (60, 60, 60), (60,) * 12),
    ]
    return _p(*specs[idx])
