"""The plaintext-matrix kernel's yardstick (``csrc/ct_matrix.cu``): the
least time the card could take for one layer, from its shape alone.

A layer of ``outputs`` ciphertexts from ``inputs`` ciphertexts at ``limbs``
limbs of degree N must read each input word once, write each output word
once and read its constants (a weight a nonzero tap and limb, a bias an
output and limb): 8 bytes a word at the memory rate.  It must also form
each nonzero product of a scalar and a ciphertext, 2 x limbs x N modular
products, each at least ceil(b_w / 8) x ceil(b_q / 8) byte products (b_w
the bits of the largest weight, sign included; b_q those of the limb's
modulus) of 2 operations at the int8 tensor-core peak, the cheapest
integer product the card has.  Its bound is the larger of the two times,
so no route of the kernel can read above 100 %.
"""

from __future__ import annotations

import math

from fhe_bench.roofline import HBM_BYTES_PER_S, INT8_OPS_PER_S, WORD


def layer_bound_s(layer: dict) -> float:
    """The yardstick of one layer (a work file's ``layers`` entry:
    outputs, inputs, nonzeros, limbs, n, q_bits, weight_bits), in
    seconds."""
    limbs, n = layer["limbs"], layer["n"]
    words = (2 * (layer["inputs"] + layer["outputs"]) * n + layer["nonzeros"] + layer["outputs"]) \
        * limbs
    t_bytes = words * WORD / HBM_BYTES_PER_S
    byte_products = math.ceil(layer["weight_bits"] / 8) * sum(math.ceil(b / 8)
                                                              for b in layer["q_bits"])
    t_ops = layer["nonzeros"] * 2 * n * byte_products * 2 / INT8_OPS_PER_S
    return max(t_bytes, t_ops)


def work_bound_s(work: dict) -> float:
    """The yardstick of every layer one request runs (a work file's
    ``layers``)."""
    return sum(layer_bound_s(layer) for layer in work["layers"])
