"""Plain CKKS (Lattigo v1.3.1 ckks/) for the reference: the moduli of a
parameter set, the canonical embedding (encoding slots into integer
coefficients and back), the scale and level after a rescale, and the
decryption of an NTT-domain ciphertext with a secret given by its integer
coefficients.  Imports torch, numpy and the plain ring beside it: nothing of
the program under test.

Slot order (ckks/encoder.go): slot j is the plaintext polynomial's value at
exp(i pi 5^j / N), j < N/2, over its scale; the coefficients are real.
"""

from __future__ import annotations

import numpy as np
import torch

from fhe_bench.reference.ring import NTT, gen_moduli, mulmod


def moduli(cfg: dict) -> dict[str, list[int]]:
    """Q and P of a configuration (ckks/utils.go GenModuli)."""
    q, p = gen_moduli(cfg["log_n"], cfg["log_qi"], cfg["log_pi"])
    return dict(q=q, p=p)


class Scheme:
    """The plain scheme at one configuration, on ``device``."""

    def __init__(self, cfg: dict, device=None):
        self.n = 1 << cfg["log_n"]
        self.slots = 1 << cfg["log_slots"]
        if self.slots != self.n // 2:
            raise ValueError("the reference encodes full slots only")
        self.scale = float(cfg["scale"])
        self.qs = moduli(cfg)["q"]
        self.device = device
        e = np.empty(self.slots, dtype=np.int64)
        x = 1
        for j in range(self.slots):
            e[j] = x
            x = x * 5 % (2 * self.n)
        self.pos = (e - 1) // 2  # slot j at the odd power 2 pos + 1
        self.conj = (2 * self.n - e - 1) // 2
        self.twist = np.exp(1j * np.pi * np.arange(self.n) / self.n)

    def encode(self, values: np.ndarray) -> np.ndarray:
        """[..., N/2] complex slots -> round(scale * m), int64 [..., N]."""
        ev = np.zeros((*values.shape[:-1], self.n), dtype=np.complex128)
        ev[..., self.pos] = values
        ev[..., self.conj] = np.conj(values)
        m = (np.fft.fft(ev, axis=-1) / self.n / self.twist).real
        return np.rint(m * self.scale).astype(np.int64)

    def decode(self, coeffs: np.ndarray, scale: float) -> np.ndarray:
        """[..., N] integer coefficients (as float64) -> [..., N/2] slots."""
        ev = np.fft.ifft(coeffs * self.twist, axis=-1) * self.n
        return ev[..., self.pos] / scale

    def mul_rescale(self, scale: float, level: int) -> tuple[float, int]:
        """Scale and level of the product of two ciphertexts at ``scale``,
        ``level`` after Rescale (ckks/evaluator.go: divide by the last
        modulus while the scale stays at or above the default scale times
        that modulus over 2)."""
        scale *= scale
        while level and scale >= self.scale * self.qs[level] / 2:
            scale /= self.qs[level]
            level -= 1
        return scale, level

    def judge(self, ct: torch.Tensor, secret: torch.Tensor, want: np.ndarray, scale: float,
              level: int) -> dict:
        """Decrypts ``ct`` ([2, ..., L, N], NTT domain) with ``secret``
        (integer coefficients [N]) and holds it against ``want`` ([..., N/2]
        complex): ``limb_mismatch`` (coefficients whose residues disagree
        with the integer of limb 0, centred; the message is far below
        q_0 / 2) and ``max_err`` (the largest |slot - want|)."""
        f = NTT(self.qs[: level + 1], self.n, ct.device)
        s_hat = f.forward(f.residues(secret.to(ct.device)))
        c0, c1 = ct[0] % f.q, ct[1] % f.q
        v = f.inverse((c0 + mulmod(c1, s_hat, f.q)) % f.q)
        q0 = self.qs[0]
        v0 = v[..., 0, :]
        centred = torch.where(v0 > q0 // 2, v0 - q0, v0)
        mismatch = int((centred[..., None, :] % f.q != v).sum())
        slots = self.decode(centred.double().cpu().numpy(), scale)
        return dict(limb_mismatch=mismatch, max_err=float(np.abs(slots - want).max()))


def control_err(a: np.ndarray, b: np.ndarray) -> float:
    """The largest |a b - want| of the product computed in complex64, the
    precision below the configuration's float64 slots."""
    lower = (a.astype(np.complex64) * b.astype(np.complex64)).astype(np.complex128)
    return float(np.abs(lower - a * b).max())
