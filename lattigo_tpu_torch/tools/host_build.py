"""The arithmetic of the modular kernels built for the host CPU.

``csrc/modred.cu``, ``csrc/mod_up.cu``, ``csrc/key_switch.cu`` and
``csrc/ct_matrix.cu`` keep their per-element, per-column and per-tile
arithmetic outside ``#ifdef __CUDACC__`` (``csrc/modarith.cuh`` maps
``__umul64hi`` to a 128-bit product there).  :func:`load` compiles a
source with the host C++ compiler behind a C entry of the same name and
signature as the CUDA one (the stream is ignored), looping over rows and
coefficient columns as the kernel's threads do.  A library it returns can
stand in for the CUDA one behind the real wrappers, so that the CPU tests
run the kernels' own source on the launch plans of a whole path.  Nothing
here runs on a GPU.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

from lattigo_tpu_torch import _build

HARNESS = {
    "modred": r"""
#include "modred.cu"
template <int OP>
static void run(const Args& a) {
    for (long long r = 0; r < a.rows; ++r)
        for (long long n = 0; n < a.N; ++n) {
            const long long b = r / a.L, l = r - b * a.L;
            const auto at = [&](int s) -> u64 {
                const Operand& o = a.o[s];
                return o.p[b * o.sb + l * o.sl + n * o.sn];
            };
            a.out[r * a.N + n] = apply<OP>(at);
        }
}
typedef void (*Fn)(const Args&);
static const Fn FNS[N_OPS] = {run<0>, run<1>, run<2>, run<3>, run<4>, run<5>, run<6>, run<7>,
                              run<8>, run<9>, run<10>, run<11>, run<12>, run<13>, run<14>};
extern "C" int modred_launch(int op, const long long* desc, void* out, long long B,
                             long long L, long long N, void* stream) {
    if (op < 0 || op >= N_OPS || B < 1 || L < 1 || N < 1 || !desc || !out || !desc[4 * Q])
        return -2;
    Args a;
    for (int s = 0; s < SLOTS; ++s)
        a.o[s] = Operand{(const u64*)desc[4 * s], desc[4 * s + 1], desc[4 * s + 2],
                         desc[4 * s + 3]};
    a.out = (u64*)out;
    a.rows = B * L;
    a.L = L;
    a.N = N;
    FNS[op](a);
    return 0;
}
""",
    "mod_up": r"""
#include <vector>
#include "mod_up.cu"
extern "C" int mod_up_launch(const void* x, long long sb, long long sl, long long sn,
                             const void* tab, const void* sel, void* out, long long B,
                             long long N, int ls, int ld, int k, int centered, void* stream) {
    if (!x || !tab || !sel || !out || B < 1 || N < 1 || ls < 1 || ld < 1 || k < 1) return -2;
    std::vector<u64> ys(ls);
    for (long long b = 0; b < B; ++b)
        for (long long n = 0; n < N; ++n)
            mod_up_column((const u64*)x + b * sb + n * sn, sl, (const u64*)tab,
                          (const int*)sel, ys.data(), 1, (u64*)out + b * k * N + n, N, ls, ld,
                          k, centered);
    return 0;
}
extern "C" int decompose_launch(const void* x, long long sb, long long sl, long long sn,
                                const void* tab, void* out, long long B, long long N, int L,
                                int K, int beta, int words, int max_ls, void* stream) {
    if (!x || !tab || !out || B < 1 || N < 1 || L < 1 || K < 1 || beta < 1 || words < 0 ||
        max_ls < 1)
        return -2;
    const u64* t = (const u64*)tab;
    std::vector<u64> ys(max_ls);
    for (long long b = 0; b < B; ++b)
        for (int j = 0; j < beta; ++j) {
            const u64* head = t + DIGIT_WORDS * j;
            const u64* params = (const u64*)head[2];
            for (long long n = 0; n < N; ++n)
                digit_column((const u64*)x + b * sb + n * sn, sl, params, ys.data(), 1,
                             (u64*)out + ((b * beta + j) * (L + K)) * N + n, N, (int)head[0],
                             (int)head[1], L, K);
        }
    return 0;
}
""",
    "key_switch": r"""
#include "key_switch.cu"
static void run(int tile, const Args& a, long long b0, int l, long long n) {
    switch (tile) {
        case 1: key_switch_tile<1>(a, b0, l, n); break;
        case 2: key_switch_tile<2>(a, b0, l, n); break;
        case 4: key_switch_tile<4>(a, b0, l, n); break;
        default: key_switch_tile<MAX_TILE>(a, b0, l, n);
    }
}
extern "C" int key_switch_launch(const void* d, const long long* dstr, const void* key0,
                                 const void* key1, const long long* kstr, const void* q,
                                 const void* qinv, const void* u0, const void* ql,
                                 const void* idx, void* out, long long B, long long N, int L,
                                 int beta, void* stream) {
    Args a;
    if (make_args(a, d, dstr, key0, key1, kstr, q, qinv, u0, ql, idx, out, B, N, L, beta))
        return -2;
    const int tile = tile_of(B);
    for (long long b0 = 0; b0 < B; b0 += tile)
        for (int l = 0; l < L; ++l)
            for (long long n = 0; n < N; ++n)
                run(tile, a, b0, l, n);
    return 0;
}
""",
    "ct_matrix": r"""
#include "ct_matrix.cu"
template <int TILE>
static void run(const Args& a) {
    for (long long t = 0; t < a.T; ++t) {
        const long long* tile = a.tiles + t * TABLE;
        for (int l = 0; l < a.L; ++l) {
            const u64* c = a.consts + l * CONSTS;
            for (long long n = 0; n < a.N; ++n) {
                u64 lo[2][TILE] = {}, hi[2][TILE] = {};
                int pending = 0;
                accumulate<TILE>(a, a.col + tile[0], a.w + (l * a.P + tile[0]) * MAX_TILE,
                                 (int)tile[1], (int)tile[2], l * a.sl + n * a.sn, c, lo, hi,
                                 pending);
                finish<TILE>(a, tile, l, n, c, lo, hi);
            }
        }
    }
}
extern "C" int ct_matrix_launch(const void* x0, const void* x1, const long long* xstr,
                                const void* w, const void* col, const void* tiles,
                                const void* bias, const void* consts, void* out, long long T,
                                long long P, long long J, long long N, int L, int tile,
                                int fold, void* stream) {
    Args a;
    if (make_args(a, x0, x1, xstr, w, col, tiles, bias, consts, out, T, P, J, N, L, tile, fold))
        return -2;
    switch (tile) {
        case 1: run<1>(a); break;
        case 2: run<2>(a); break;
        case 4: run<4>(a); break;
        default: run<MAX_TILE>(a);
    }
    return 0;
}
""",
}

_libs: dict[str, ctypes.CDLL] = {}


def _paths(name: str) -> tuple[list[str], str]:
    deps = [os.path.join(_build.CSRC, name + ".cu"), os.path.join(_build.CSRC, "modarith.cuh"),
            os.path.abspath(__file__)]
    return deps, os.path.join(_build.BUILD, "host", f"lib{name}_host.so")


def load(name: str) -> ctypes.CDLL:
    """The host build of ``csrc/<name>.cu`` (``modred``, ``mod_up``,
    ``key_switch`` or ``ct_matrix``), compiled into ``build/host/`` when
    missing or older than its sources."""
    if name in _libs:
        return _libs[name]
    deps, lib = _paths(name)
    if not os.path.exists(lib) or any(os.path.getmtime(d) > os.path.getmtime(lib) for d in deps):
        os.makedirs(os.path.dirname(lib), exist_ok=True)
        tmp = f"{lib}.{os.getpid()}"
        src = tmp + ".cpp"
        with open(src, "w") as f:
            f.write(HARNESS[name])
        try:
            subprocess.run([os.environ.get("CXX") or "c++", "-std=c++17", "-O1", "-shared",
                            "-fPIC", "-I", _build.CSRC, "-o", tmp, src],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, lib)
        finally:
            os.remove(src)
    _libs[name] = _build.bind(ctypes.CDLL(lib), name)
    return _libs[name]
