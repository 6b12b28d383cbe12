"""Plain BFV (Lattigo v1.3.1 bfv/) for the reference: the moduli of a
parameter set, batch encoding and decoding of Z_t slots, decryption with a
secret given by its integer coefficients, and the noise of a ciphertext
against the plaintext it should hold.  Imports torch, numpy and the plain
ring beside it: nothing of the program under test.

Slot order (bfv/encoder.go): slot j of the first row is the plaintext
polynomial's value at psi_t^(5^j), slot j of the second row its value at
psi_t^(-5^j), j < N/2, psi_t Lattigo's 2N-th root of unity mod t.
"""

from __future__ import annotations

import numpy as np
import torch

from fhe_bench.reference.ring import NTT, gen_moduli, mulmod


def moduli(cfg: dict) -> dict[str, list[int]]:
    """Q, P and QMul of a configuration (bfv/utils.go GenModuli)."""
    q, p, qmul = gen_moduli(cfg["log_n"], cfg["log_qi"], cfg["log_pi"], cfg["log_qi_mul"])
    return dict(q=q, p=p, qmul=qmul)


def slot_positions(n: int, device=None) -> torch.Tensor:
    """[N]: the index in Lattigo's NTT order (mod t) of each slot."""
    exps = np.empty(n, dtype=np.int64)
    e = 1
    for j in range(n // 2):
        exps[j], exps[j + n // 2] = e, 2 * n - e
        e = e * 5 % (2 * n)
    bits = n.bit_length() - 1
    half = (exps - 1) // 2
    rev = np.zeros_like(half)
    for b in range(bits):
        rev |= ((half >> b) & 1) << (bits - 1 - b)
    return torch.from_numpy(rev).to(device)


class Scheme:
    """The plain scheme at one configuration, on ``device``."""

    def __init__(self, cfg: dict, device=None):
        self.n, self.t = 1 << cfg["log_n"], cfg["t"]
        self.qs = moduli(cfg)["q"]
        self.big_q = int(np.prod([int(q) for q in self.qs], dtype=object))
        self.ntt_q = NTT(self.qs, self.n, device)
        self.ntt_t = NTT([self.t], self.n, device)
        self.slots = slot_positions(self.n, device)
        self.device = device

    def encode(self, values: torch.Tensor) -> torch.Tensor:
        """[..., N] slot values mod t -> the plaintext's coefficients mod t."""
        ev = torch.empty_like(values)
        ev[..., self.slots] = values
        return self.ntt_t.inverse(ev[..., None, :])[..., 0, :]

    def decode(self, coeffs: torch.Tensor) -> torch.Tensor:
        """[..., N] coefficients mod t -> the slot values."""
        return self.ntt_t.forward(coeffs[..., None, :])[..., 0, self.slots]

    def phase(self, ct: torch.Tensor, secret: torch.Tensor) -> torch.Tensor:
        """[2, ..., L, N] coefficient-domain ciphertext and the secret's
        integer coefficients [N] -> c0 + c1 * s mod each q_i."""
        f = self.ntt_q
        s_hat = f.forward(f.residues(secret))
        c0, c1 = ct[0] % f.q, ct[1] % f.q
        return (c0 + f.inverse(mulmod(f.forward(c1), s_hat, f.q))) % f.q

    def crt(self, limbs: torch.Tensor) -> list[list[int]]:
        """[..., L, N] residues -> the integers mod Q they stand for, one
        list of N Python ints for each leading index."""
        rows = limbs.reshape(-1, len(self.qs), self.n).cpu().numpy()
        weights = []
        for q in self.qs:
            rest = self.big_q // q
            weights.append(rest * pow(rest, -1, q))
        out = []
        for row in rows:
            acc = sum(row[i].astype(object) * w for i, w in enumerate(weights))
            out.append(list(acc % self.big_q))
        return out

    def judge(self, ct: torch.Tensor, secret: torch.Tensor, want_slots: torch.Tensor) -> dict:
        """Decrypts ``ct`` ([2, L, N]) with ``secret`` and holds it against
        ``want_slots`` ([N] mod t): ``wrong_slots`` (slots that decrypt to
        another value) and ``noise`` (the largest |t v - Q m| over Q/2,
        v the phase, m the wanted plaintext, taken centred mod tQ: it is
        below 1 exactly where every coefficient decrypts right)."""
        v = self.crt(self.phase(ct, secret))[0]
        want = [int(x) for x in self.encode(want_slots.to(self.device)).cpu().tolist()]
        t, big_q = self.t, self.big_q
        got = [(t * x + big_q // 2) // big_q % t for x in v]  # round(t v / Q) mod t
        got_slots = self.decode(torch.tensor(got, dtype=torch.int64, device=self.device))
        wrong = int((got_slots != want_slots.to(self.device)).sum())
        tq = t * big_q
        worst = 0
        for x, m in zip(v, want):
            r = (t * x - big_q * m) % tq
            worst = max(worst, min(r, tq - r))
        return dict(wrong_slots=wrong, noise=2 * worst / big_q)
