"""Plain reference of CryptoNets' MNIST network (request kind
``cryptonets``): its weights, biases and pixels drawn from the seed, its
logits in float64 plain PyTorch, the level and scale Lattigo's rules leave,
and the work one request needs (NTT transforms, and each layer's shape for
the plaintext-matrix kernel's yardstick).

The network (Gilad-Bachrach et al., ICML 2016): a 5 x 5 convolution of
stride 2 with 5 maps and a bias each over the 28 x 28 image padded with a
zero row and column at the bottom and right, a square, a dense layer 845
-> 100, a square, a dense layer 100 -> 10.  Served batched over the slots
(nGraph-HE2, WAHC 2019): ciphertext i holds pixel i of every image, one
image a slot, and the answer's ciphertext c holds logit c of every image.

Imports numpy, torch and the plain references beside it: nothing of the
program under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from fhe_bench.reference import cheby as ref_cheby

BIAS = 0.1  # biases uniform in +-BIAS


def shapes(cfg: dict) -> dict:
    """The network's sizes: the conv's outputs a side, its outputs, and
    the inputs, outputs and fan-in of each layer."""
    out = (cfg["padded"] - cfg["kernel"]) // cfg["stride"] + 1
    conv = cfg["maps"] * out * out
    return dict(side=out, conv=conv, pixels=cfg["image"] ** 2,
                fan_in=dict(conv=cfg["kernel"] ** 2, dense1=conv, dense2=cfg["hidden"]))


def model(cfg: dict) -> dict:
    """The served model: one set of weights, drawn from the configuration's
    ``model_seed`` (a deployment serves one trained model), uniform in
    +-sqrt(3 / fan-in) (outputs of about unit variance), and biases, uniform
    in +-0.1: ``conv_w`` [maps, k, k], ``conv_b``, ``w1`` [hidden, conv
    outputs], ``b1``, ``w2`` [classes, hidden], ``b2``."""
    rng = np.random.default_rng(np.random.SeedSequence(cfg["model_seed"]))
    sh = shapes(cfg)
    k, maps, hidden, classes = cfg["kernel"], cfg["maps"], cfg["hidden"], cfg["classes"]

    def uni(fan_in, shape):
        return rng.uniform(-math.sqrt(3 / fan_in), math.sqrt(3 / fan_in), shape)

    return dict(conv_w=uni(k * k, (maps, k, k)), conv_b=rng.uniform(-BIAS, BIAS, maps),
                w1=uni(sh["conv"], (hidden, sh["conv"])), b1=rng.uniform(-BIAS, BIAS, hidden),
                w2=uni(hidden, (classes, hidden)), b2=rng.uniform(-BIAS, BIAS, classes))


def draw(cfg: dict, pool: int, seed: int) -> tuple[np.ndarray, dict, np.ndarray]:
    """The benchmark's inputs at ``seed``: the secret's coefficients [N]
    (``hw`` nonzero, +-1); the weights and biases (:func:`model`, the same
    at every seed); the pixels [pool, images, image, image], uniform in [0,
    1], ``images`` the slots."""
    n = 1 << cfg["log_n"]
    rng = np.random.default_rng(np.random.SeedSequence(seed))
    hw = cfg["secret_hamming_weight"]
    secret = np.zeros(n, dtype=np.int64)
    secret[rng.choice(n, hw, replace=False)] = rng.choice([-1, 1], hw)
    pixels = rng.uniform(0, 1, (pool, 1 << cfg["log_slots"], cfg["image"], cfg["image"]))
    return secret, model(cfg), pixels


def expected(cfg: dict, w: dict, pixels: np.ndarray) -> np.ndarray:
    """The logits [..., images, classes] of ``pixels`` [..., images, image,
    image] in float64 plain PyTorch on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float64))  # noqa: E731
    lead = pixels.shape[:-2]
    x = t(pixels).reshape(-1, 1, cfg["image"], cfg["image"])
    pad = cfg["padded"] - cfg["image"]
    x = F.pad(x, (0, pad, 0, pad))  # zeros at the right and the bottom
    x = F.conv2d(x, t(w["conv_w"])[:, None], t(w["conv_b"]), stride=cfg["stride"])
    x = x.flatten(1) ** 2
    x = F.linear(x, t(w["w1"]), t(w["b1"])) ** 2
    x = F.linear(x, t(w["w2"]), t(w["b2"]))
    return x.reshape(*lead, cfg["classes"]).numpy()


def _rescale(qs: list[int], default: float, scale: float, level: int, divided: list[int]):
    """Lattigo's Rescale (ckks/evaluator.go): divide by the last modulus
    while the scale stays at or above the default scale times that modulus
    over 2."""
    while level and scale >= default * qs[level] / 2:
        divided.append(level)
        scale /= float(qs[level])
        level -= 1
    return scale, level


def trace(qs: list[int], default: float, level: int) -> tuple[list[tuple], float, int]:
    """The network's steps from inputs at ``level`` and the default scale:
    ``[(step, level before, levels divided), ...]``, the answer's scale and
    level.  A layer multiplies the scale by the default scale (its weights'
    ``MultByConst``), a square squares it, each is rescaled."""
    steps, scale = [], float(default)
    for step in ("conv", "square1", "dense1", "square2", "dense2"):
        before = level
        scale = scale * scale if step.startswith("square") else scale * default
        divided: list[int] = []
        scale, level = _rescale(qs, default, scale, level, divided)
        steps.append((step, before, divided))
    return steps, scale, level


def work(cfg: dict, qs: list[int], n_p: int) -> dict:
    """One request's work at Q = ``qs`` and ``n_p`` moduli of P, inputs at
    the top level: ``transforms``, the NTT transforms Lattigo's algorithm
    needs (``reference.cheby.work``: each square relinearizes its whole
    stack, each rescale divides every ciphertext of its stack), and
    ``layers``, each layer's outputs, inputs, nonzero taps, limbs, degree,
    the bits of each limb's modulus and those of its largest weight
    (round(|w| Delta), sign included), for the plaintext-matrix kernel's
    yardstick."""
    sh = shapes(cfg)
    n, default = 1 << cfg["log_n"], float(cfg["scale"])
    steps, _, _ = trace(qs, default, len(qs) - 1)
    stack = dict(conv=sh["conv"], square1=sh["conv"], dense1=cfg["hidden"],
                 square2=cfg["hidden"], dense2=cfg["classes"])
    k, side, image = cfg["kernel"], sh["side"], cfg["image"]
    # taps on real pixels: each output (y, x) of a map reads the k x k window
    # at (stride y, stride x), cut at the image's edge
    real = [max(0, min(k, image - cfg["stride"] * i)) for i in range(side)]
    nonzeros = dict(conv=cfg["maps"] * sum(real) ** 2, dense1=cfg["hidden"] * sh["conv"],
                    dense2=cfg["classes"] * cfg["hidden"])
    inputs = dict(conv=sh["pixels"], dense1=sh["conv"], dense2=cfg["hidden"])
    events, layers = [], []
    for step, level, divided in steps:
        if step.startswith("square"):
            events += [("product", level)] * stack[step]
        else:
            bound = math.sqrt(3 / sh["fan_in"][step]) * default
            layers.append(dict(layer=step, outputs=stack[step], inputs=inputs[step],
                               nonzeros=nonzeros[step], limbs=level + 1, n=n,
                               q_bits=[q.bit_length() for q in qs[: level + 1]],
                               weight_bits=int(bound).bit_length() + 1))
        for lvl in divided:
            events += [("rescale", lvl)] * stack[step]
    return dict(transforms=ref_cheby.work(qs, n_p, n, events), layers=layers)
