"""Binary serialization, byte-compatible with the reference's marshalers.

Counterpart of ``lattigo_tpu/utils/serialization.py``: the same bytes for
the same objects.  Formats (all big-endian):

* Poly (ring/ring_object.go:161-289): ``[log2(N) u8][#moduli u8]`` then one
  row of N uint64 coefficients per modulus.
* Ciphertext (bfv/marshaler.go:9-60, ckks/marshaler.go adds the scale):
  ``[degree+1 u8][isNTT u8]`` then the polys.
* SecretKey/PublicKey/SwitchingKey/EvaluationKey/RotationKeys mirror
  bfv/marshaler.go:75-443.
* The protocol shares of dBFV and dCKKS in the reference's per-share
  formats, and the kind-tagged ``share_to_bytes`` of older checkpoints.

The ``*_to_bytes`` functions take the port's int64 tensors on any device
and copy each tensor to the host once; the ``*_from_bytes`` functions give
tensors on ``device`` (``None`` means the GPU, as everywhere in the port).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from lattigo_tpu_torch import device as _device
from lattigo_tpu_torch.ops import u64 as u


# -- Poly -------------------------------------------------------------------


def _rows_bytes(arr: np.ndarray) -> bytes:
    """One [L, N] uint64 array in the poly format."""
    L, n = arr.shape
    return bytes([n.bit_length() - 1, L]) + arr.astype(">u8").tobytes()


def _read_rows(data, ptr: int) -> tuple[np.ndarray, int]:
    """The [L, N] uint64 array of the poly at ``data[ptr:]`` and the offset
    after it."""
    n, L = 1 << data[ptr], data[ptr + 1]
    arr = np.frombuffer(data, dtype=">u8", count=L * n, offset=ptr + 2).reshape(L, n)
    return arr.astype(np.uint64), ptr + 2 + 8 * L * n


def _read_many(data, ptr: int, count: int) -> tuple[list[np.ndarray], int]:
    out = []
    for _ in range(count):
        arr, ptr = _read_rows(data, ptr)
        out.append(arr)
    return out, ptr


def _tensor(arrs, device) -> torch.Tensor:
    """One uint64 array, or a list of them stacked, as a tensor on ``device``."""
    arr = np.stack(arrs) if isinstance(arrs, list) else arrs
    return u.from_u64(arr, _device.resolve(device))


def poly_to_bytes(x: torch.Tensor) -> bytes:
    if x.ndim != 2:
        raise ValueError("poly_to_bytes expects a [L, N] poly")
    return _rows_bytes(u.to_u64(x))


def poly_from_bytes(data: bytes, device=None) -> tuple[torch.Tensor, int]:
    """Returns (poly, bytes consumed)."""
    arr, end = _read_rows(data, 0)
    return _tensor(arr, device), end


def _stacked_bytes(x: torch.Tensor) -> list[bytes]:
    """A [beta, L, N] tensor as beta polys, copied to the host once."""
    return [_rows_bytes(a) for a in u.to_u64(x)]


# -- Ciphertext -------------------------------------------------------------


def _ciphertext_bytes(ct, meta: bytes) -> bytes:
    head = bytes([len(ct.value), 1 if ct.is_ntt else 0]) + meta
    return head + b"".join(poly_to_bytes(p) for p in ct.value)


def bfv_ciphertext_to_bytes(ct) -> bytes:
    return _ciphertext_bytes(ct, b"")


def bfv_ciphertext_from_bytes(data: bytes, device=None):
    from lattigo_tpu_torch.models.bfv.elements import Ciphertext

    polys, _ = _read_many(data, 2, data[0])
    return Ciphertext([_tensor(p, device) for p in polys], data[1] == 1)


def ckks_ciphertext_to_bytes(ct) -> bytes:
    """ckks adds the float64 scale to the metadata (ckks/marshaler.go)."""
    return _ciphertext_bytes(ct, struct.pack(">d", ct.scale))


def ckks_ciphertext_from_bytes(data: bytes, device=None):
    from lattigo_tpu_torch.models.ckks.elements import Ciphertext

    (scale,) = struct.unpack(">d", data[2:10])
    polys, _ = _read_many(data, 10, data[0])
    return Ciphertext([_tensor(p, device) for p in polys], scale, data[1] == 1)


# -- protocol shares (the dbfv/dckks wire protocol, kind-tagged) -------------


def share_to_bytes(share) -> bytes:
    """A protocol share: a poly, a stacked [beta, L, N] tensor, or a pair of
    those (PCKS/Refresh two-part shares).  Format: [kind u8] + payload;
    kind 0 = poly, 1 = stacked, 2 = pair.  A poly is one tensor here, so a
    pair is a tuple (the JAX package tells its two-plane polys from pairs
    by ``ndim``); the bytes are the same."""
    if isinstance(share, tuple):
        a, b = share_to_bytes(share[0]), share_to_bytes(share[1])
        return bytes([2]) + len(a).to_bytes(4, "big") + a + b
    if share.ndim == 3:
        return bytes([1, share.shape[0]]) + b"".join(_stacked_bytes(share))
    return bytes([0]) + poly_to_bytes(share)


def share_from_bytes(data: bytes, device=None):
    kind = data[0]
    if kind == 0:
        return poly_from_bytes(data[1:], device)[0]
    if kind == 1:
        return _tensor(_read_many(data, 2, data[1])[0], device)
    if kind == 2:
        alen = int.from_bytes(data[1:5], "big")
        return (share_from_bytes(data[5 : 5 + alen], device),
                share_from_bytes(data[5 + alen :], device))
    raise ValueError(f"unknown share kind {kind}")


# -- keys -------------------------------------------------------------------


def secret_key_to_bytes(sk) -> bytes:
    return poly_to_bytes(sk.sk)


def secret_key_from_bytes(data: bytes, cls, device=None):
    return cls(poly_from_bytes(data, device)[0])


def public_key_to_bytes(pk) -> bytes:
    return poly_to_bytes(pk.pk[0]) + poly_to_bytes(pk.pk[1])


def public_key_from_bytes(data: bytes, cls, device=None):
    (p0, p1), _ = _read_many(data, 0, 2)
    return cls((_tensor(p0, device), _tensor(p1, device)))


def switching_key_to_bytes(swk) -> bytes:
    """[beta u8] then per block: key0 poly, key1 poly
    (bfv/marshaler.go:248-273)."""
    k0, k1 = _stacked_bytes(swk.key0), _stacked_bytes(swk.key1)
    return bytes([len(k0)]) + b"".join(a + b for a, b in zip(k0, k1))


def switching_key_from_bytes(data: bytes, cls, device=None) -> tuple[object, int]:
    """Returns (key, bytes consumed)."""
    beta = data[0]
    polys, ptr = _read_many(data, 1, 2 * beta)
    return cls(_tensor(polys[0::2], device), _tensor(polys[1::2], device)), ptr


def evaluation_key_to_bytes(evk) -> bytes:
    keys = evk.evakey if isinstance(evk.evakey, list) else [evk.evakey]
    return bytes([len(keys)]) + b"".join(switching_key_to_bytes(k) for k in keys)


def evaluation_key_from_bytes(data: bytes, evk_cls, swk_cls, single: bool = False, device=None):
    """``single``: the CKKS key holds one switching key, not a list."""
    ptr = 1
    keys = []
    for _ in range(data[0]):
        swk, inc = switching_key_from_bytes(data[ptr:], swk_cls, device)
        keys.append(swk)
        ptr += inc
    return evk_cls(keys[0] if single else keys)


# rotation record types (bfv/keygen.go:40-45, ckks/keygen.go:44-49):
# RotationRight = 1, RotationLeft = 2, RotationRow/Conjugate = 3
ROT_RIGHT, ROT_LEFT, ROT_EXTRA = 1, 2, 3


def rotation_keys_to_bytes(rk) -> bytes:
    """Reference RotationKeys format (bfv/marshaler.go:330-385): records
    ``[type u8][k u24-big-endian]`` + SwitchingKey bytes; the row/conjugate
    record carries k = 0.  Left keys first, then right, then row/conjugate."""
    extra = getattr(rk, "row", None)
    if extra is None:
        extra = getattr(rk, "conjugate", None)
    out = b""
    for kind, keys in ((ROT_LEFT, rk.left), (ROT_RIGHT, rk.right)):
        for k in sorted(keys):
            out += bytes([kind]) + int(k).to_bytes(3, "big") + switching_key_to_bytes(keys[k])
    if extra is not None:
        out += bytes([ROT_EXTRA, 0, 0, 0]) + switching_key_to_bytes(extra)
    return out


def rotation_keys_from_bytes(data: bytes, rk_cls, swk_cls, device=None):
    rk = rk_cls()
    ptr = 0
    while ptr < len(data):
        rot_type = data[ptr]
        k = int.from_bytes(data[ptr + 1 : ptr + 4], "big")
        swk, inc = switching_key_from_bytes(data[ptr + 4 :], swk_cls, device)
        ptr += 4 + inc
        if rot_type == ROT_LEFT:
            rk.left[k] = swk
        elif rot_type == ROT_RIGHT:
            rk.right[k] = swk
        elif rot_type == ROT_EXTRA:
            if hasattr(rk, "row"):
                rk.row = swk
            else:
                rk.conjugate = swk
        else:
            raise ValueError(f"unknown rotation record type {rot_type}")
    return rk


# -- Parameters ---------------------------------------------------------------


def bfv_parameters_to_bytes(p) -> bytes:
    """bfv/params.go:263-285: [logN u8][#Qi u8][#Pi u8][#QiMul u8]
    [T u64][sigma*2^32 u64][Qi...][Pi...][QiMul...], big-endian."""
    out = bytes([p.log_n, len(p.qi), len(p.pi), len(p.qi_mul)])
    out += struct.pack(">QQ", p.t, int(p.sigma * (1 << 32)))
    return out + b"".join(struct.pack(">Q", v) for v in (*p.qi, *p.pi, *p.qi_mul))


def bfv_parameters_from_bytes(data: bytes):
    from lattigo_tpu_torch.models.bfv.params import Parameters

    log_n, n_qi, n_pi, n_mul = data[0], data[1], data[2], data[3]
    t, sig = struct.unpack(">QQ", data[4:20])
    vals = struct.unpack(f">{n_qi + n_pi + n_mul}Q", data[20 : 20 + 8 * (n_qi + n_pi + n_mul)])
    sigma = round((sig / (1 << 32)) * 100) / 100
    return Parameters(log_n=log_n, t=t, sigma=sigma, qi=tuple(vals[:n_qi]),
                      pi=tuple(vals[n_qi : n_qi + n_pi]), qi_mul=tuple(vals[n_qi + n_pi :]))


def ckks_parameters_to_bytes(p) -> bytes:
    """ckks/params.go:269-291: [logN u8][logSlots u8][scale f64][sigma f64]
    [#Qi u8][#Pi u8][Qi...][Pi...], big-endian."""
    out = bytes([p.log_n, p.log_slots]) + struct.pack(">dd", p.scale, p.sigma)
    out += bytes([len(p.qi), len(p.pi)])
    return out + b"".join(struct.pack(">Q", v) for v in (*p.qi, *p.pi))


def ckks_parameters_from_bytes(data: bytes):
    from lattigo_tpu_torch.models.ckks.params import Parameters

    log_n, log_slots = data[0], data[1]
    scale, sigma = struct.unpack(">dd", data[2:18])
    n_qi, n_pi = data[18], data[19]
    vals = struct.unpack(f">{n_qi + n_pi}Q", data[20 : 20 + 8 * (n_qi + n_pi)])
    return Parameters(log_n=log_n, log_slots=log_slots, scale=scale, sigma=sigma,
                      qi=tuple(vals[:n_qi]), pi=tuple(vals[n_qi:]))


# -- reference-format protocol share codecs ---------------------------------
#
# Byte-identical to the reference's per-share MarshalBinary wire formats.

ROTATION_RIGHT, ROTATION_LEFT, ROTATION_ROW = 1, 2, 3  # bfv/keygen.go:42-44


def ckg_share_to_bytes(share: torch.Tensor) -> bytes:
    """CKGShare = bare poly (dbfv/publickey_gen.go:21-27)."""
    return poly_to_bytes(share)


def ckg_share_from_bytes(data: bytes, device=None) -> torch.Tensor:
    return poly_from_bytes(data, device)[0]


def cks_share_to_bytes(share: torch.Tensor) -> bytes:
    """CKSShare = bare poly (dbfv/keyswitching.go:20-33)."""
    return poly_to_bytes(share)


def cks_share_from_bytes(data: bytes, device=None) -> torch.Tensor:
    return poly_from_bytes(data, device)[0]


def pcks_share_to_bytes(share) -> bytes:
    """PCKSShare = two polys, no header (dbfv/public_keyswitching.go:30-48)."""
    return poly_to_bytes(share[0]) + poly_to_bytes(share[1])


def pcks_share_from_bytes(data: bytes, device=None):
    (p0, p1), _ = _read_many(data, 0, 2)
    return _tensor(p0, device), _tensor(p1, device)


def rkg_round1_share_to_bytes(share: torch.Tensor) -> bytes:
    """[beta u8] + beta polys (dbfv/relinkey_gen.go:28-43)."""
    return bytes([share.shape[0]]) + b"".join(_stacked_bytes(share))


def rkg_round1_share_from_bytes(data: bytes, device=None) -> torch.Tensor:
    return _tensor(_read_many(data, 1, data[0])[0], device)


rkg_round3_share_to_bytes = rkg_round1_share_to_bytes
rkg_round3_share_from_bytes = rkg_round1_share_from_bytes


def rkg_round2_share_to_bytes(share) -> bytes:
    """[beta u8] + beta x (poly0, poly1) (dbfv/relinkey_gen.go:69-95)."""
    s0, s1 = _stacked_bytes(share[0]), _stacked_bytes(share[1])
    return bytes([len(s0)]) + b"".join(a + b for a, b in zip(s0, s1))


def rkg_round2_share_from_bytes(data: bytes, device=None):
    polys, _ = _read_many(data, 1, 2 * data[0])
    return _tensor(polys[0::2], device), _tensor(polys[1::2], device)


def rtg_share_to_bytes(k: int, rot_type: int, share: torch.Tensor) -> bytes:
    """[K u64][Type u64][lenRing u64] + beta polys
    (dbfv/rotkey_gen.go:29-46)."""
    polys = _stacked_bytes(share)
    return struct.pack(">QQQ", k, rot_type, len(polys[0])) + b"".join(polys)


def rtg_share_from_bytes(data: bytes, device=None):
    """Returns (k, rot_type, stacked share)."""
    k, rot_type, len_ring = struct.unpack(">QQQ", data[:24])
    polys, end = _read_many(data, 24, (len(data) - 24) // len_ring)
    if end != len(data):
        raise ValueError("RTG share length is not a whole number of polys")
    return int(k), int(rot_type), _tensor(polys, device)


def refresh_share_to_bytes(share) -> bytes:
    """[lenDecrypt u64][lenRecrypt u64] + decrypt poly + recrypt poly
    (dbfv/public_refresh.go:32-54; dckks identically)."""
    d, r = poly_to_bytes(share[0]), poly_to_bytes(share[1])
    return struct.pack(">QQ", len(d), len(r)) + d + r


def refresh_share_from_bytes(data: bytes, device=None):
    len_d, _ = struct.unpack(">QQ", data[:16])
    d, _ = _read_rows(data, 16)
    r, _ = _read_rows(data, 16 + len_d)
    return _tensor(d, device), _tensor(r, device)
