"""Builds the CUDA sources under ``csrc/`` into shared libraries with a plain
C interface and loads them with ``ctypes``.

One ``nvcc`` per source, all started together; the libraries go into
``build/`` beside this file and are rebuilt when a source is newer than its
library.  Nothing is built at import time: the first CUDA tensor that reaches
a kernel wrapper triggers the build.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD = os.path.join(_HERE, "build")
SOURCES = ("ntt_row", "ntt_fourstep", "ntt_passes", "modred", "mod_up", "key_switch")

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _paths(name: str) -> tuple[str, str]:
    return os.path.join(CSRC, name + ".cu"), os.path.join(BUILD, f"lib{name}.so")


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    deps = [src, os.path.join(CSRC, "modarith.cuh")]
    return not os.path.exists(lib) or any(
        os.path.getmtime(d) > os.path.getmtime(lib) for d in deps
    )


def build(names=SOURCES, verbose: bool = False) -> dict[str, str]:
    """Compile every stale source of ``names`` for sm_90a, in parallel.
    Returns nvcc's output for each source it compiled (with ``verbose``,
    ptxas' resource report)."""
    todo = [n for n in names if _stale(n)]
    logs: dict[str, str] = {}
    if not todo:
        return logs
    os.makedirs(BUILD, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        src, lib = _paths(name)
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [
            nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-shared", "-Xcompiler", "-fPIC", "-o", tmp, src,
        ]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
            continue
        logs[name] = out
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if it is stale."""
    if name not in _libs:
        build((name,))
        _libs[name] = ctypes.CDLL(_paths(name)[1])
    return _libs[name]
