"""CKKS element model (ckks/operand.go): NTT-domain polynomials carrying a
(scale, level) pair.  A polynomial is an int64 tensor [..., lvl+1, N]; the
level is the number of carried limbs - 1, and leading dims stack
ciphertexts."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Ciphertext:
    value: list[torch.Tensor]  # degree+1 polys
    scale: float
    is_ntt: bool = True

    @property
    def degree(self) -> int:
        return len(self.value) - 1

    @property
    def level(self) -> int:
        return self.value[0].shape[-2] - 1

    def copy(self) -> "Ciphertext":
        return Ciphertext(list(self.value), self.scale, self.is_ntt)


@dataclasses.dataclass
class Plaintext:
    value: torch.Tensor
    scale: float
    is_ntt: bool = True

    @property
    def degree(self) -> int:
        return 0

    @property
    def level(self) -> int:
        return self.value.shape[-2] - 1


def polys_of(op) -> list[torch.Tensor]:
    if isinstance(op, Plaintext):
        return [op.value]
    return op.value


def drop_to_level(x: torch.Tensor, lvl: int) -> torch.Tensor:
    return x[..., : lvl + 1, :]
