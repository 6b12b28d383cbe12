"""Carrying state between numpy and the port: polynomials, ciphertexts and
keys as ``uint64`` arrays on the host, int64 tensors on the device.  The JAX
package's objects cross over as the ``uint64`` arrays its ``u64.to_u64``
gives; nothing here imports it.  BFV and CKKS share the key classes but not
the rotation keys (BFV's have the row swap, CKKS's the conjugation); CKKS
ciphertexts and plaintexts carry their scale (the level is the limb count).
Threshold-protocol shares are polys, beta-stacked polys or pairs of them
(a dCKKS refresh pair holds h0 at the ciphertext's level and h1 at the top
level)."""

from __future__ import annotations

import numpy as np
import torch

from lattigo_tpu_torch.models import ckks
from lattigo_tpu_torch.models.bfv.elements import Ciphertext
from lattigo_tpu_torch.models.bfv.keygen import PublicKey, SecretKey, SwitchingKey
from lattigo_tpu_torch.models.bfv.keygen import RotationKeys as BFVRotationKeys
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


def ckks_ciphertext_from_numpy(polys, scale: float, device) -> ckks.Ciphertext:
    """One uint64 array [..., lvl+1, N] per degree, NTT domain."""
    return ckks.Ciphertext([poly_from_numpy(p, device) for p in polys], float(scale))


def ckks_ciphertext_to_numpy(ct: ckks.Ciphertext) -> tuple[list[np.ndarray], float]:
    return [poly_to_numpy(p) for p in ct.value], ct.scale


def ckks_plaintext_from_numpy(poly: np.ndarray, scale: float, device) -> ckks.Plaintext:
    return ckks.Plaintext(poly_from_numpy(poly, device), float(scale))


def ckks_plaintext_to_numpy(pt: ckks.Plaintext) -> tuple[np.ndarray, float]:
    return poly_to_numpy(pt.value), pt.scale


def rotation_keys_from_numpy(left: dict, right: dict, conjugate, device) -> ckks.RotationKeys:
    """``left`` / ``right``: rotation -> (key0, key1) uint64 planes;
    ``conjugate``: (key0, key1) or None."""
    carry = lambda k: switching_key_from_numpy(*k, device)
    return ckks.RotationKeys(
        {r: carry(k) for r, k in left.items()}, {r: carry(k) for r, k in right.items()},
        None if conjugate is None else carry(conjugate))


def rotation_keys_to_numpy(rk: ckks.RotationKeys) -> tuple[dict, dict, tuple | None]:
    return ({r: switching_key_to_numpy(k) for r, k in rk.left.items()},
            {r: switching_key_to_numpy(k) for r, k in rk.right.items()},
            None if rk.conjugate is None else switching_key_to_numpy(rk.conjugate))


def bfv_rotation_keys_from_numpy(left: dict, right: dict, row, device) -> BFVRotationKeys:
    """``left`` / ``right``: rotation -> (key0, key1) uint64 planes;
    ``row``: (key0, key1) or None."""
    carry = lambda k: switching_key_from_numpy(*k, device)
    return BFVRotationKeys(
        {r: carry(k) for r, k in left.items()}, {r: carry(k) for r, k in right.items()},
        None if row is None else carry(row))


def bfv_rotation_keys_to_numpy(rk: BFVRotationKeys) -> tuple[dict, dict, tuple | None]:
    return ({r: switching_key_to_numpy(k) for r, k in rk.left.items()},
            {r: switching_key_to_numpy(k) for r, k in rk.right.items()},
            None if rk.row is None else switching_key_to_numpy(rk.row))


def share_from_numpy(share, device):
    """A protocol share: one uint64 array (a poly [L, N] or a beta-stacked
    [beta, L, N]) or a pair of them."""
    if isinstance(share, (tuple, list)):
        return tuple(share_from_numpy(s, device) for s in share)
    return poly_from_numpy(share, device)


def share_to_numpy(share):
    if isinstance(share, (tuple, list)):
        return tuple(share_to_numpy(s) for s in share)
    return poly_to_numpy(share)
