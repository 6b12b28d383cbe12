"""Plain reference of the encrypted dense layer (request kind
``ckks_matvec``): its weights and inputs drawn from the seed, the layer's
extended diagonals and its answer in float64, the level and scale Lattigo's
rules leave, and the NTT transforms one request needs.

The layer is GAZELLE's hybrid diagonal method (Juvekar, Vaikuntanathan and
Chandrakasan, USENIX Security 2018) for an m x n matrix W over n slots, m
dividing n: the extended diagonals ``diag_k[i] = W[i mod m][(i + k) mod n]``,
``z = sum_k diag_k * rot_k(x)`` with ``rot_k(x)[i] = x[(i + k) mod n]``, and
log2(n / m) rotate-and-add steps, after which every block of m slots holds
``W x``: so the answer is ``W x`` tiled n / m times.  The circuit splits the
m diagonals into n1 baby steps and m / n1 giant steps (Halevi and Shoup,
CRYPTO 2018): one hoisted decomposition serves the n1 - 1 baby rotations,
each giant and fold rotation decomposes on its own (Lattigo v1.3.1
``RotateHoisted``, ckks/evaluator.go:1252-1392; ``RotateColumns`` and
``switchKeysInPlace``), and one ``Rescale`` ends it.

Imports numpy alone: nothing of the program under test.
"""

from __future__ import annotations

import math

import numpy as np


def draw(cfg: dict, pool: int, seed: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The benchmark's inputs at ``seed``: the secret's coefficients [N]
    (``hw`` nonzero, +-1), the weights [rows, cols], uniform in
    +-sqrt(3 / cols) (outputs of unit variance), and the real slots
    [pool, cols], uniform on the configuration's interval."""
    n = 1 << cfg["log_n"]
    rng = np.random.default_rng(np.random.SeedSequence(seed))
    hw = cfg["secret_hamming_weight"]
    secret = np.zeros(n, dtype=np.int64)
    secret[rng.choice(n, hw, replace=False)] = rng.choice([-1, 1], hw)
    rows, cols = cfg["rows"], cfg["cols"]
    bound = math.sqrt(3 / cols)
    w = rng.uniform(-bound, bound, (rows, cols))
    lo, hi = cfg["interval"]
    return secret, w, rng.uniform(lo, hi, (pool, cols))


def diagonals(w: np.ndarray) -> np.ndarray:
    """The m extended diagonals of ``w`` [m, n]: [m, n], row k holding
    ``w[i mod m][(i + k) mod n]`` at slot i."""
    m, n = w.shape
    i = np.arange(n)
    return w[(i % m)[None, :], (i[None, :] + np.arange(m)[:, None]) % n]


def hybrid(w: np.ndarray, x: np.ndarray) -> np.ndarray:
    """The method itself in float64 on the slots ``x`` [..., n]: the sum of
    the diagonals times the rotations of x, then the fold steps n/2, ...,
    m."""
    m, n = w.shape
    z = sum(d * np.roll(x, -k, axis=-1) for k, d in enumerate(diagonals(w)))
    step = n >> 1
    while step >= m:
        z = z + np.roll(z, -step, axis=-1)
        step >>= 1
    return z


def expected(w: np.ndarray, x: np.ndarray) -> np.ndarray:
    """The layer's answer on the slots ``x`` [..., n]: ``W x`` in every
    block of m slots."""
    m, n = w.shape
    return np.tile(x @ w.T, n // m)


def output(qs: list[int], default_scale: float, scale: float, pt_scale: float,
           level: int) -> tuple[float, int, list[int]]:
    """Scale and level after a ciphertext at ``scale``, ``level`` times
    plaintexts at ``pt_scale`` (MulRelin: the scales multiply) is rescaled
    (ckks/evaluator.go Rescale: divide by the last modulus while the scale
    stays at or above the default scale times that modulus over 2), and
    the levels divided from."""
    scale *= pt_scale
    divided = []
    while level and scale >= default_scale * qs[level] / 2:
        divided.append(level)
        scale /= float(qs[level])
        level -= 1
    return scale, level, divided


def work(qs: list[int], n_p: int, n: int, level: int, m: int, n1: int, slots: int,
         divided: list[int]) -> list[dict]:
    """The NTT transforms Lattigo's algorithm needs for one layer at level
    ``level`` (Q = ``qs``, ``n_p`` moduli of P, degree ``n``): the hoisted
    decomposition (c1 to coefficients; each of the beta = ceil((l + 1) /
    n_p) digits extended to the Q limbs outside it and to P), two ModDowns
    (the P limbs to coefficients, the extension to Q back) for each of the
    n1 - 1 baby rotations; for each of the m / n1 - 1 giant and log2(slots
    / m) fold rotations a decomposition and two ModDowns of its own; and a
    rescale division from each level of ``divided`` (the last limb of both
    polynomials to coefficients, then reduced by each other modulus back
    to the NTT domain).  Transforms of one shape and step are one entry
    with a ``count``."""
    out: dict[tuple, dict] = {}

    def add(rows, limbs, inverse, step, count):
        key = (rows, limbs, inverse, step)
        if not count:
            return
        if key in out:
            out[key]["count"] += count
        else:
            out[key] = dict(rows=rows, limbs=limbs, n=n, inverse=inverse, count=count, step=step)

    nq = level + 1
    beta = -(-nq // n_p)
    folds = int(math.log2(slots // m))

    def decomposition(what, count):
        add(nq, nq, True, f"{what} at level {level}: c1 to coefficients", count)
        add(beta * nq - nq + beta * n_p, nq + n_p, False,
            f"{what} at level {level}: the {beta} digits extended to the Q limbs outside each "
            f"and the {n_p} P limbs", count)

    def mod_downs(what, count):
        add(n_p, n_p, True, f"{what} at level {level}: ModDown, the P limbs to coefficients",
            2 * count)
        add(nq, nq, False, f"{what} at level {level}: ModDown, the extension to Q back", 2 * count)

    decomposition("hoisted decomposition", 1)
    mod_downs("baby rotation", n1 - 1)
    for what, count in (("giant rotation", m // n1 - 1), ("fold rotation", folds)):
        decomposition(what, count)
        mod_downs(what, count)
    for lvl in divided:
        add(2, 1, True, f"rescale from level {lvl}: the last limb to coefficients", 1)
        add(2 * lvl, lvl, False, f"rescale from level {lvl}: the last limb reduced by each "
                                 "other modulus, to the NTT domain", 1)
    return list(out.values())
