"""Unsigned 64-bit arithmetic on ``torch.int64`` carriers.

Every coefficient, twiddle and reduction constant of the port is one
``torch.int64`` element holding the *bit pattern* of a uint64 (the JAX
package carries two ``uint32`` planes instead, ``lattigo_tpu/ops/u64.py``).
Wrapping add / sub / low multiply are the native int64 ops (two's complement
wraps mod 2^64 exactly like Go's uint64).  What a signed carrier gets wrong
is fixed here:

* ``>>`` on int64 is arithmetic: :func:`shr` masks the sign fill away;
* ``<`` is signed: :func:`lt` / :func:`ge` compare after flipping the sign bit;
* there is no 64x64 -> 128 product: :func:`mul64_128` builds it from 32-bit
  halves, summing the carries in 32-bit columns.

All helpers are elementwise, broadcast like torch ops and work on any device.
"""

from __future__ import annotations

import numpy as np
import torch

_MIN = -(1 << 63)  # the sign bit as an int64
_M32 = 0xFFFFFFFF


def from_u64(a, device) -> torch.Tensor:
    """numpy uint64 array (or nested ints < 2^64) -> int64 tensor on ``device``."""
    arr = np.ascontiguousarray(np.asarray(a, dtype=np.uint64))
    return torch.from_numpy(arr.view(np.int64).copy()).to(device)


def to_u64(x: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy uint64 array (host readback)."""
    return x.detach().cpu().contiguous().numpy().view(np.uint64)


def lt(x: torch.Tensor, y) -> torch.Tensor:
    """Unsigned x < y."""
    return (x ^ _MIN) < (y ^ _MIN)


def ge(x: torch.Tensor, y) -> torch.Tensor:
    """Unsigned x >= y."""
    return (x ^ _MIN) >= (y ^ _MIN)


def shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical x >> n for a static 0 <= n < 64."""
    if n == 0:
        return x
    return (x >> n) & ((1 << (64 - n)) - 1)


def add_carry(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(x + y) mod 2^64 and the carry-out (int64 0/1)."""
    s = x + y
    return s, lt(s, y).to(torch.int64)


def mul64_128(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Full 64x64 -> 128 product as (lo64, hi64), the analog of Go's
    ``bits.Mul64``.  The four 32x32 partial products are exact in 64 bits;
    their middle column (three values < 2^32) cannot overflow either."""
    x0, x1 = x & _M32, shr(x, 32)
    y0, y1 = y & _M32, shr(y, 32)
    p00, p01, p10, p11 = x0 * y0, x0 * y1, x1 * y0, x1 * y1
    mid = shr(p00, 32) + (p01 & _M32) + (p10 & _M32)
    hi = p11 + shr(p01, 32) + shr(p10, 32) + shr(mid, 32)
    return x * y, hi


def mulhi64(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """High 64 bits of the unsigned product x*y."""
    return mul64_128(x, y)[1]
