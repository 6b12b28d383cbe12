"""Precision-statistics utility for approximate (CKKS) computations.

The port's own copy of ``lattigo_tpu/utils/precision.py`` (numpy only): the
reference's test-only precision tracker (ckks/ckks_test.go:155-231) as a
tool, with per-slot error stats (min/max/mean/median bits) and a log2-error
histogram.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PrecisionStats:
    min_bits: float
    max_bits: float
    mean_bits: float
    median_bits: float
    histogram: dict[int, int]  # floor(log2(1/err)) -> count

    def __str__(self) -> str:
        lines = [
            f"precision (bits): min={self.min_bits:.2f} max={self.max_bits:.2f} "
            f"mean={self.mean_bits:.2f} median={self.median_bits:.2f}",
        ]
        for b in sorted(self.histogram):
            lines.append(f"  {b:>3} bits: {'*' * min(self.histogram[b], 60)}")
        return "\n".join(lines)


def precision_stats(got, want, eps: float = 1e-16) -> PrecisionStats:
    err = np.abs(np.asarray(got) - np.asarray(want))
    err = np.maximum(err, eps)
    bits = np.log2(1 / err)
    hist: dict[int, int] = {}
    for b in np.floor(bits).astype(int):
        hist[int(b)] = hist.get(int(b), 0) + 1
    return PrecisionStats(
        float(bits.min()),
        float(bits.max()),
        float(bits.mean()),
        float(np.median(bits)),
        hist,
    )
