"""The arithmetic of the modular kernels built for the host CPU.

``csrc/modred.cu``, ``csrc/mod_up.cu``, ``csrc/key_switch.cu`` and
``csrc/ct_matrix.cu`` keep their per-element, per-column and per-lane
arithmetic outside ``#ifdef __CUDACC__`` (``csrc/modarith.cuh`` maps
``__umul64hi`` to a 128-bit product there).  :func:`load` compiles a
source with the host C++ compiler behind a C entry of the same name and
signature as the CUDA one (the stream is ignored), looping over rows and
coefficient columns as the kernel's threads do; for ``ct_matrix`` over
the warps of each block, each warp's 32 lanes at once, the tensor-core
product replaced by a loop over the same fragments' byte products.  A
library it returns can stand in for the CUDA one behind the real
wrappers, so that the CPU tests run the kernels' own source on the launch
plans of a whole path.  Nothing here runs on a GPU.
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
#include <vector>
#include "ct_matrix.cu"
// A warp's registers: lane i's at [i].
struct WarpFrag {
    unsigned r[32][4];
};
struct WarpAcc {
    int c[32][4];
};
struct WarpB {
    u64 w[32];
};
// mma.sync m16n8k32 (u8 x s8 -> s32, the sums wrapping mod 2^32) over the
// warp's fragments: A row r, column k in lane (r % 8) 4 + (k % 16) / 4,
// register r / 8 + 2 (k / 16), byte k % 4; B column n, row k in lane
// 4 n + (k % 16) / 4, word half k / 16, byte k % 4; C (r, n) in lane
// 4 (r % 8) + n / 2, register 2 (r / 8) + n % 2.
struct HostMma {
    void operator()(WarpAcc& c, const WarpFrag& a, const WarpB& b) const {
        for (int lane = 0; lane < 32; ++lane)
            for (int i = 0; i < 4; ++i) {
                const int r = (lane >> 2) + 8 * (i >> 1), n = 2 * (lane & 3) + (i & 1);
                long long sum = 0;
                for (int k = 0; k < KSTEP; ++k) {
                    const int q = (k & 15) >> 2, byte = 8 * (k & 3);
                    const unsigned ar = a.r[(r & 7) * 4 + q][(r >> 3) + 2 * (k >> 4)];
                    const unsigned av = ar >> byte & 0xff;
                    const int bv = (signed char)(b.w[4 * n + q] >> (32 * (k >> 4) + byte) & 0xff);
                    sum += (long long)av * bv;
                }
                c.c[lane][i] = (int)((unsigned)c.c[lane][i] + (unsigned)sum);
            }
    }
};
// A warp on the host: each lane's planes, and a step for all 32 lanes.
template <int DW, int DXM, int TPW>
struct HostWarp {
    static constexpr int E = DW + DXM - 1;
    const u64 *x0[32], *x1[32];  // each lane's coefficient of x_h (the last one past N)
    WarpAcc acc[TPW][E];
    void step(const int* col, int sk, int ch, const u64* wd, long long stride, int tiles, int dx,
              int end, const long long* tile, long long n0, int l, const u64* c, const Args& a) {
        WarpFrag f[DXM];
        for (int lane = 0; lane < 32; ++lane) {
            u64 w[2][2][4];
            load_words(col, sk, ch, x0[lane], x1[lane], lane, w);
            Frag lf[DXM];
            split<DXM>(w, dx, lf);
            for (int d = 0; d < DXM; ++d)
                for (int i = 0; i < 4; ++i) f[d].r[lane][i] = lf[d].r[i];
        }
        for (int t = 0; t < tiles; ++t) {
            WarpB b[DW];
            for (int lane = 0; lane < 32; ++lane) {
                u64 lb[DW];
                load_b<DW>(wd + t * stride + lane, lb);
                for (int i = 0; i < DW; ++i) b[i].w[lane] = lb[i];
            }
            products<DW, DXM>(acc[t], f, b, dx, HostMma());
            for (int lane = 0; lane < 32; ++lane) {
                int mine[E][4];
                for (int e = 0; e < E; ++e)
                    for (int i = 0; i < 4; ++i) mine[e][i] = acc[t][e].c[lane][i];
                if (end == 2)
                    store<E>(a, tile + t * TABLE, l, n0, lane, mine, limb_of(c));
                else if (end)
                    fold<E>(mine, limb_of(c));
                for (int e = 0; e < E; ++e)
                    for (int i = 0; i < 4; ++i) acc[t][e].c[lane][i] = mine[e][i];
            }
        }
    }
};
// The kernel's blocks in turn, each warp walking its run.
template <int DW, int DXM, int TPW>
static void layer(const Args& a) {
    const long long strips = (a.N + 8 * a.ss - 1) / (8 * a.ss), runs = (a.S + a.run - 1) / a.run;
    const int warps = (a.tb + TPW - 1) / TPW * a.ss;
    static HostWarp<DW, DXM, TPW> warp;
    for (int l = 0; l < a.L; ++l)
        for (long long by = 0; by < strips; ++by)
            for (long long bx = 0; bx < runs; ++bx)
                for (int w = 0; w < warps; ++w) {
                    warp = HostWarp<DW, DXM, TPW>{};
                    for (int lane = 0; lane < 32; ++lane) {
                        const long long n = (by * a.ss + w % a.ss) * 8 + (lane >> 2);
                        const long long at = l * a.sl + (n < a.N ? n : a.N - 1) * a.sn;
                        warp.x0[lane] = a.x0 + at;
                        warp.x1[lane] = a.x1 + at;
                    }
                    walk<DW, TPW>(a, bx, by, l, w, warp);
                }
}
template <int DXM>
static void layer(const Args& a) {
    if (DXM == 6 && a.tpw == 2) switch (a.dw) {
            case 1: return layer<1, 6, 2>(a);
            case 2: return layer<2, 6, 2>(a);
            case 3: return layer<3, 6, 2>(a);
            case 4: return layer<4, 6, 2>(a);
            default: return layer<5, 6, 2>(a);
        }
    switch (a.dw) {
        case 1: return layer<1, DXM, 1>(a);
        case 2: return layer<2, DXM, 1>(a);
        case 3: return layer<3, DXM, 1>(a);
        case 4: return layer<4, DXM, 1>(a);
        case 5: return layer<5, DXM, 1>(a);
        case 6: return layer<6, DXM, 1>(a);
        case 7: return layer<7, DXM, 1>(a);
        default: return layer<8, DXM, 1>(a);
    }
}
extern "C" int ct_matrix_launch(const void* x0, const void* x1, const long long* xstr,
                                const void* wd, const void* col, const void* tiles,
                                const void* slabs, const void* bias, const void* consts,
                                void* out, long long S, long long WK, long long J, long long N,
                                int L, int dw, int dx, int tb, int tpw, int ss, int run,
                                int fold, void* stream) {
    Args a;
    if (make_args(a, x0, x1, xstr, wd, col, tiles, slabs, bias, consts, out, S, WK, J, N, L, dw,
                  dx, tb, tpw, ss, run, fold))
        return -2;
    dx <= 6 ? layer<6>(a) : layer<8>(a);
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
