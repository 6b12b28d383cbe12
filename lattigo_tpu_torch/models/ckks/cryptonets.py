"""CryptoNets' MNIST network (Gilad-Bachrach et al., "CryptoNets: Applying
Neural Networks to Encrypted Data with High Throughput and Accuracy", ICML
2016) on CKKS, batched over the slots as nGraph-HE2 runs it (Boemer et
al., WAHC 2019): ciphertext i holds pixel i of every image of the batch,
one image a slot, so that each layer is a plaintext matrix of scalars
applied to a stack of ciphertexts.

The network: a 5 x 5 convolution of stride 2 with 5 maps over the image
padded by zero rows and columns at the bottom and right (28 x 28 padded
to 29 x 29 gives 5 x 13 x 13 = 845 outputs), a square, a dense layer
845 -> 100 (the paper folds its pooling and second convolution into it),
a square, a dense layer 100 -> 10.  The padding pixels are known zeros:
they are not encrypted, and the convolution's taps on them are left out.

Levels follow Lattigo's rules: each layer (``Evaluator.mul_plain_matrix``)
and each square (``mul_relin`` with the relinearization key) is followed by
a ``rescale``; where each divides by one modulus (PN14QP438 at the scale
2^34), a network that starts at level l ends at level l - 5, with one
ciphertext a logit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from lattigo_tpu_torch.models.ckks.elements import Ciphertext
from lattigo_tpu_torch.models.ckks.plain_matrix import PlainMatrix


def conv_taps(w: np.ndarray, image: int, padded: int, stride: int):
    """The convolution of ``w`` [maps, k, k] over an ``image`` x ``image``
    input padded with zeros to ``padded`` x ``padded`` at the bottom and
    right, as the taps of a matrix: ``(rows, cols, values, n_out)``, output
    ``(m, y, x)`` at row ``(m out + y) out + x`` (``out`` outputs a side),
    input pixel ``(r, c)`` at column ``r image + c``; taps on padding pixels
    are left out."""
    maps, k, _ = w.shape
    out = (padded - k) // stride + 1
    m, y, x, dy, dx = np.indices((maps, out, out, k, k)).reshape(5, -1)
    r, c = y * stride + dy, x * stride + dx
    real = (r < image) & (c < image)
    rows = ((m * out + y) * out + x)[real]
    return rows, (r * image + c)[real], w[m, dy, dx][real], maps * out * out


@dataclasses.dataclass
class Network:
    """The three layers as plaintext matrices."""

    conv: PlainMatrix
    dense1: PlainMatrix
    dense2: PlainMatrix

    @classmethod
    def of(cls, conv_w, conv_b, w1, b1, w2, b2, *, image: int, padded: int,
           stride: int) -> Network:
        """From the weights: ``conv_w`` [maps, k, k] and ``conv_b`` [maps]
        (one input channel), ``w1`` [h, maps out^2] and ``b1`` [h], ``w2``
        [classes, h] and ``b2`` [classes]; the convolution as
        :func:`conv_taps` (CryptoNets: 28, 29, 2)."""
        conv_w = np.asarray(conv_w, dtype=np.float64)
        rows, cols, values, n_out = conv_taps(conv_w, image, padded, stride)
        bias = np.repeat(np.asarray(conv_b, dtype=np.float64), n_out // len(conv_w))
        return cls(PlainMatrix(rows, cols, values, n_out, image * image, bias),
                   PlainMatrix.dense(w1, b1), PlainMatrix.dense(w2, b2))

    def forward(self, ev, ct: Ciphertext, rlk) -> Ciphertext:
        """The network on ``ct`` (polys [pixels, lvl + 1, N], a pixel a
        ciphertext): polys [classes, lvl - 4, N], a logit a ciphertext."""
        x = ev.rescale(ev.mul_plain_matrix(ct, self.conv))
        x = ev.rescale(ev.mul_relin(x, x, rlk))
        x = ev.rescale(ev.mul_plain_matrix(x, self.dense1))
        x = ev.rescale(ev.mul_relin(x, x, rlk))
        return ev.rescale(ev.mul_plain_matrix(x, self.dense2))
