"""BFV element model: degree-d ciphertexts and degree-0 plaintexts
(bfv/operand.go, bfv/ciphertext.go, bfv/plaintext.go).

A ciphertext is a list of degree+1 polynomials in basis Q, coefficient
domain, each an int64 tensor [..., L, N]; leading dims stack ciphertexts.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Ciphertext:
    value: list[torch.Tensor]
    is_ntt: bool = False

    @property
    def degree(self) -> int:
        return len(self.value) - 1

    def copy(self) -> "Ciphertext":
        return Ciphertext(list(self.value), self.is_ntt)


@dataclasses.dataclass
class Plaintext:
    value: torch.Tensor  # one poly in basis Q (lifted by Delta)
    is_ntt: bool = False

    @property
    def degree(self) -> int:
        return 0


def polys_of(op) -> list[torch.Tensor]:
    """Uniform access to the polynomial vector of a Ciphertext/Plaintext."""
    if isinstance(op, Plaintext):
        return [op.value]
    return op.value
