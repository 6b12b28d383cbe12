"""CKKS parameter sets (ckks/params.go).

Parameters carry the ciphertext chain Qi and the key-switch special primes
Pi.  Prime synthesis follows ckks/utils.go:148-191: primes of each bit size
are drawn from one shared pool in the order Qi, Pi, so the generated moduli
match the reference's exactly.
"""

from __future__ import annotations

import dataclasses

from lattigo_tpu_torch.ops import number_theory as nt


@dataclasses.dataclass
class Parameters:
    log_n: int
    log_slots: int
    scale: float
    log_qi: tuple[int, ...] = ()
    log_pi: tuple[int, ...] = ()
    sigma: float = 3.2
    qi: tuple[int, ...] = ()
    pi: tuple[int, ...] = ()

    @property
    def n(self) -> int:
        return 1 << self.log_n

    @property
    def slots(self) -> int:
        return 1 << self.log_slots

    @property
    def max_level(self) -> int:
        return len(self.qi) - 1

    @property
    def alpha(self) -> int:
        return len(self.pi)

    def beta(self, level: int | None = None) -> int:
        lvl = self.max_level if level is None else level
        return -(-(lvl + 1) // self.alpha)

    def gen_from_log_moduli(self) -> "Parameters":
        """ckks/utils.go:148-191: shared per-bitsize prime pools, Qi then Pi."""
        if self.qi:
            return self
        sizes: dict[int, int] = {}
        for b in (*self.log_qi, *self.log_pi):
            if b > 60:
                raise ValueError("moduli bit-size must be <= 60")
            sizes[b] = sizes.get(b, 0) + 1
        pools = {b: nt.generate_ntt_primes(b, self.log_n, c) for b, c in sizes.items()}
        self.qi = tuple(pools[b].pop(0) for b in self.log_qi)
        self.pi = tuple(pools[b].pop(0) for b in self.log_pi)
        self._validate()
        return self

    def _validate(self):
        two_n = 2 << self.log_n
        seen = set()
        for q in (*self.qi, *self.pi):
            if q in seen:
                raise ValueError(f"duplicate modulus {q}")
            seen.add(q)
            if not nt.is_prime(q) or q % two_n != 1:
                raise ValueError(f"modulus {q} is not an NTT prime for N=2^{self.log_n}")

    def copy(self) -> "Parameters":
        return dataclasses.replace(self)


# Default 128-bit-secure sets (ckks/params.go:35-87).
PN12QP109 = 0
PN13QP218 = 1
PN14QP438 = 2
PN15QP880 = 3
PN16QP1761 = 4


def default_params(idx: int) -> Parameters:
    specs = [
        (12, 11, float(1 << 32), (37, 32), (38,)),
        (13, 12, float(1 << 30), (33, 30, 30, 30, 30, 30), (35,)),
        (14, 13, float(1 << 34), (45,) + (34,) * 9, (43, 43)),
        (15, 14, float(1 << 40), (50,) + (40,) * 17, (50, 50, 50)),
        (16, 15, float(1 << 45), (55,) + (45,) * 33, (55, 55, 55, 55)),
    ]
    log_n, log_slots, scale, lq, lp = specs[idx]
    return Parameters(
        log_n=log_n, log_slots=log_slots, scale=scale, log_qi=lq, log_pi=lp
    ).gen_from_log_moduli()
