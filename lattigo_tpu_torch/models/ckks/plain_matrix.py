"""A real matrix of plaintext scalars applied to a stack of ciphertexts:
output ciphertext j = sum_k w[j, k] x_k + b[j], the k running over the
nonzero taps of row j (every input for a dense layer, the window of a
convolution), as :meth:`Evaluator.mul_plain_matrix` computes it in one
launch of ``csrc/ct_matrix.cu`` (``ops/ct_matrix.py``).

Lattigo v1.3.1 has no such routine: its users write a loop of
``MultByConstAndAdd`` (ckks/evaluator.go:446) over the weights and an
``AddConst`` of the bias.  The scale rules are those: a weight with a
fraction is encoded as round(w Delta), Delta the set's default scale, and
multiplies the ciphertext's scale by Delta (``MultByConst``; a whole-number
weight gives the same words through ``Add``'s integer scale ratio); the
bias is encoded as round(b s) at the product's scale s (``AddConst``).
Rounding halves away from zero (ckks/utils.go scaleUpExact).
"""

from __future__ import annotations

import numpy as np

from lattigo_tpu_torch.models.ckks.encoder import scale_up_vec_exact
from lattigo_tpu_torch.ops import ct_matrix


class PlainMatrix:
    """The ``n_out`` x ``n_in`` real matrix whose nonzero taps are
    ``values[i]`` at (``rows[i]``, ``cols[i]``), and a bias per output (or
    None).  Its integer tables are made once per (moduli, scales, device),
    on first use (outside any captured program: the warm-up call of a
    ``tjit`` program builds them), and kept."""

    def __init__(self, rows, cols, values, n_out: int, n_in: int, bias=None):
        self.rows = np.asarray(rows, dtype=np.int64)
        self.cols = np.asarray(cols, dtype=np.int64)
        self.values = np.asarray(values, dtype=np.float64)
        if not self.rows.shape == self.cols.shape == self.values.shape or self.rows.ndim != 1:
            raise ValueError("rows, cols and values are three vectors of one length")
        self.n_out, self.n_in = n_out, n_in
        self.bias = None if bias is None else np.asarray(bias, dtype=np.float64)
        if self.bias is not None and self.bias.shape != (n_out,):
            raise ValueError(f"a bias of {self.bias.shape} for {n_out} outputs")
        self._tables: dict = {}

    @classmethod
    def dense(cls, w, bias=None) -> PlainMatrix:
        """Every entry of ``w`` [n_out, n_in] a tap."""
        w = np.asarray(w, dtype=np.float64)
        rows, cols = np.indices(w.shape).reshape(2, -1)
        return cls(rows, cols, w.ravel(), *w.shape, bias=bias)

    @property
    def products(self) -> int:
        """Scalar x ciphertext products: the nonzero taps."""
        return len(self.rows)

    def tables(self, moduli, scale: float, bias_scale: float, device) -> ct_matrix.Tables:
        """The kernel's tables at ``moduli``: the weights at ``scale``, the
        bias at ``bias_scale``."""
        key = (tuple(moduli), float(scale), float(bias_scale), str(device))
        if key not in self._tables:
            w = scale_up_vec_exact(self.values[None], scale, moduli, "cpu")[0]
            b = None if self.bias is None else \
                scale_up_vec_exact(self.bias[None], bias_scale, moduli, "cpu")[0]
            words = lambda t: t.numpy().view(np.uint64)  # noqa: E731
            self._tables[key] = ct_matrix.tables(
                self.rows, self.cols, words(w), None if b is None else words(b), moduli,
                self.n_in, self.n_out, device)
        return self._tables[key]
