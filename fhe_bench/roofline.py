"""The yardstick: the published peaks of one NVIDIA H100 SXM and the least
time the card could take for an NTT, from its shape alone.

A transform of ``rows`` polynomial rows of degree N over ``limbs``
distinct moduli must read each input word and write each output word once,
and read the twiddle tables of its moduli (a word and its Shoup companion
for each of N powers): 8 bytes a word at the memory rate.  It must also do
(N/2) log2 N butterflies a row, each a 64-bit Shoup product and its
reduction, 10 32-bit multiplies.  Its bound is the larger of the two times.

The four-step kernel computes the transform as int8 tensor-core products,
and its own yardstick (its matrices' operations at the int8 peak, its
tables' bytes) is kept here so that the kernel's figures in PERF.md can be
reproduced; ``ntt_roofline`` takes the butterfly bound whatever kernel
runs, so that routing a transform to another kernel leaves the bound as it
was.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet, HBM3
INT8_OPS_PER_S = 1979e12  # H100 SXM data sheet, dense int8 tensor-core operations
# 32-bit integer multiplies: 132 SMs x 64 a clock (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0) x 1.98 GHz, half
# the 128 float32 lanes behind the data sheet's 67 TFLOP/s: 67e12 / 4
INT32_MULS_PER_S = 67e12 / 4
MULS_PER_BUTTERFLY = 10
WORD = 8


def ntt_bound_s(rows: int, limbs: int, n: int) -> float:
    """The butterfly yardstick of one transform, in seconds."""
    t_bytes = (2 * rows * n + limbs * 2 * n) * WORD / HBM_BYTES_PER_S
    t_ops = rows * (n // 2) * int(math.log2(n)) * MULS_PER_BUTTERFLY / INT32_MULS_PER_S
    return max(t_bytes, t_ops)


def fourstep_bound_s(rows: int, limbs: int, n: int) -> float:
    """The four-step kernel's own yardstick (PERF.md's kernel table, row 2):
    its two int8 matrix products a row at the int8 peak, or the bytes of the
    data and its matrices and tables, whichever is longer."""
    n1 = n // 128
    tables = limbs * ((8 * n1) ** 2 + 1024 ** 2 + 4 * (8 * n1 + 1024) + 3 * n * WORD + 64)
    t_bytes = (2 * rows * n * WORD + tables) / HBM_BYTES_PER_S
    t_ops = rows * (2 * (8 * n1) ** 2 * 128 + 2 * n1 * 1024 ** 2) / INT8_OPS_PER_S
    return max(t_bytes, t_ops)


def work_bound_s(work: dict) -> float:
    """The butterfly yardstick of every transform one request needs (a
    work file's ``transforms``: rows, limbs, n and a count each)."""
    return sum(t["count"] * ntt_bound_s(t["rows"], t["limbs"], t["n"]) for t in work["transforms"])
