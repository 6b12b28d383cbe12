"""Carrying state between numpy and the port: polynomials, ciphertexts and
keys as ``uint64`` arrays on the host, int64 tensors on the device.  The JAX
package's objects cross over as the ``uint64`` arrays its ``u64.to_u64``
gives; nothing here imports it."""

from __future__ import annotations

import numpy as np
import torch

from lattigo_tpu_torch.models.bfv.elements import Ciphertext
from lattigo_tpu_torch.models.bfv.keygen import PublicKey, SecretKey, SwitchingKey
from lattigo_tpu_torch.ops import u64 as u


def poly_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """uint64 array [..., L, N] -> int64 tensor of the same bits."""
    return u.from_u64(a, device)


def poly_to_numpy(x: torch.Tensor) -> np.ndarray:
    return u.to_u64(x)


def ciphertext_from_numpy(polys, device) -> Ciphertext:
    """One uint64 array per ciphertext degree."""
    return Ciphertext([poly_from_numpy(p, device) for p in polys])


def ciphertext_to_numpy(ct: Ciphertext) -> list[np.ndarray]:
    return [poly_to_numpy(p) for p in ct.value]


def secret_key_from_numpy(sk: np.ndarray, device) -> SecretKey:
    return SecretKey(poly_from_numpy(sk, device))


def secret_key_to_numpy(sk: SecretKey) -> np.ndarray:
    return poly_to_numpy(sk.sk)


def public_key_from_numpy(pk0: np.ndarray, pk1: np.ndarray, device) -> PublicKey:
    return PublicKey((poly_from_numpy(pk0, device), poly_from_numpy(pk1, device)))


def public_key_to_numpy(pk: PublicKey) -> tuple[np.ndarray, np.ndarray]:
    return poly_to_numpy(pk.pk[0]), poly_to_numpy(pk.pk[1])


def switching_key_from_numpy(key0: np.ndarray, key1: np.ndarray, device) -> SwitchingKey:
    """[beta, L_QP, N] uint64 planes."""
    return SwitchingKey(poly_from_numpy(key0, device), poly_from_numpy(key1, device))


def switching_key_to_numpy(swk: SwitchingKey) -> tuple[np.ndarray, np.ndarray]:
    return poly_to_numpy(swk.key0), poly_to_numpy(swk.key1)
