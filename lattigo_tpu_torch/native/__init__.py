"""Host-side C helpers of the port, compiled with the system C compiler at
first use (``crp_walk.c``: the CRP stream's rejection walk).

Counterpart of ``lattigo_tpu/native``.  The shared library goes into the
git-ignored ``lattigo_tpu_torch/build/``, named by a hash of the source, so
the binary in use always matches the C file of the checkout.  Where no
compiler is found, :func:`crp_walk_lib` gives ``None`` and the caller takes
the NumPy walk, which computes the same words (``utils/prng._walk_numpy``).
This is host code, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(os.path.dirname(_DIR), "build")
_LIB = None
_TRIED = False


def _build() -> str | None:
    src = os.path.join(_DIR, "crp_walk.c")
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(BUILD, f"_crp_walk-{tag}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = [os.environ.get("CC") or "cc", "-O2", "-shared", "-fPIC", "-o", tmp, src]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return None
    os.replace(tmp, out)  # atomic: concurrent processes each publish a whole file
    return out


def crp_walk_lib():
    """ctypes handle to the compiled walk, or None (no C compiler)."""
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        path = _build()
        if path is not None:
            lib = ctypes.CDLL(path)
            lib.crp_walk.restype = ctypes.c_longlong
            lib.crp_walk.argtypes = [
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_longlong,
                ctypes.c_longlong, ctypes.POINTER(ctypes.c_uint64),
            ]
            _LIB = lib
    return _LIB


def walk_route() -> str:
    """Which walk serves the CRP stream: ``"c"`` or ``"numpy"``."""
    return "numpy" if crp_walk_lib() is None else "c"
