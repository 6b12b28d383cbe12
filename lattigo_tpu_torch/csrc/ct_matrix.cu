// A plaintext matrix of scalars times a stack of ciphertexts: one launch
// computes a whole layer of an encrypted network over its stack,
//
//   out[h, j, l, n] = (sum_{k in taps(j)} w[j, k, l] * x_h[k, l, n] + (h == 0) b[j, l]) mod q_l
//
// for both polynomials h of every output ciphertext j, NTT domain, every
// limb l.  Lattigo writes this as a loop of MultByConstAndAdd
// (ckks/evaluator.go:446), one scalar times one ciphertext a call; the
// key switch's fold (key_switch.cu) would need each scalar as a whole
// polynomial plane.
//
// The products are exact: each x * w is a full 128-bit product, summed in
// a 128-bit accumulator and folded back below q every `fold` products
// (the caller's bound: x and w below q, so fold * (q - 1)^2 + q < 2^128).
// A fold and the end take hi 2^64 + lo to hi r64 + lo mod q, with r64 =
// 2^64 mod q (a Shoup product) and a Barrett reduction of lo.  Every output
// word is the canonical residue in [0, q), so any exact schedule (the plain
// version in ops/ct_matrix.py, Python integers) gives the same words.
//
// Operands: x_0 and x_1, the stack's two polynomials [K, L, N], read with
// one set of (k, l, n) strides; the taps grouped into tiles, a tile being
// up to MAX_TILE outputs that read the same inputs (a dense layer's
// outputs, or the maps of a convolution at one position): tiles[t] =
// (first tap p0, taps, outputs, the outputs' indices), col[p] the input of
// tap p, w[l, p, o] the weight of output o of the tile on tap p (residue mod
// q_l); the bias b[j, l] (null: none); consts[l] = (q, u0, r64, r64 Shoup);
// out [2, J, L, N], contiguous.
//
// Design: a block takes one tile, one limb and THREADS coefficients; a
// thread owns one coefficient of both polynomials and keeps 2 x TILE
// 128-bit sums in registers, so no product goes through memory.  The
// tile's columns and weights are staged CHUNK taps at a time in shared
// memory, where every thread of the block reads the same word (a
// broadcast); a thread loads each x word once for all the tile's outputs.
// Neighbouring threads take neighbouring coefficients, so a warp reads 256
// contiguous bytes of x.  Tiles are the grid's fastest axis: the tiles of
// one (coefficient chunk, limb) run together and share their x reads
// through L2.
#include <cstdint>
#include "modarith.cuh"

constexpr int MAX_TILE = 8;   // outputs a thread sums at once
constexpr int TABLE = 3 + MAX_TILE;  // words of a tile's row in tiles
constexpr int CHUNK = 32;     // taps staged in shared memory at a time
constexpr int THREADS = 256;
constexpr int CONSTS = 4;     // q, u0, r64, r64 Shoup: words a limb

struct Args {
    const u64* x[2];  // x_h[k, l, n] at k * sk + l * sl + n * sn
    long long sk, sl, sn;
    const u64* w;  // w[l, p, o] at (l * P + p) * MAX_TILE + o
    const int* col;  // col[p]: the input of tap p
    const long long* tiles;  // [T, TABLE]
    const u64* bias;  // b[j, l] at j * L + l; null: none
    const u64* consts;  // [L, CONSTS]
    u64* out;  // [2, J, L, N], contiguous
    long long T, P, J, N;
    int L, fold;
};

// lo, hi += x * w, 128 bits.
__device__ __forceinline__ void mac(u64& lo, u64& hi, u64 x, u64 w) {
    const u64 p = x * w;
    lo += p;
    hi += __umul64hi(x, w) + (lo < p ? 1ull : 0ull);
}

// (hi 2^64 + lo) mod q in [0, q), for any 128-bit value.
__device__ __forceinline__ u64 reduce128(u64 lo, u64 hi, const u64* c) {
    const u64 q = c[0];
    u64 s = mul_shoup(hi, c[2], c[3], q) + bred_add(lo, q, c[1]);  // < 3q
    s = s >= 2 * q ? s - 2 * q : s;
    return cred(s, q);
}

// Folds `count` taps into the sums of the tile's first `nout` outputs:
// col[i] the input of tap i, w[i * MAX_TILE + o] its weight for output o;
// `off` is the thread's (limb, coefficient) offset into x; `pending`, the
// products summed since the last fold, carries over between calls.
template <int TILE>
__device__ __forceinline__ void accumulate(const Args& a, const int* col, const u64* w, int count,
                                           int nout, long long off, const u64* c,
                                           u64 (&lo)[2][TILE], u64 (&hi)[2][TILE], int& pending) {
    for (int i = 0; i < count; ++i) {
        const long long at = col[i] * a.sk + off;
        const u64 x0 = a.x[0][at], x1 = a.x[1][at];
#pragma unroll
        for (int o = 0; o < TILE; ++o) {
            if (o < nout) {
                const u64 wo = w[i * MAX_TILE + o];
                mac(lo[0][o], hi[0][o], x0, wo);
                mac(lo[1][o], hi[1][o], x1, wo);
            }
        }
        if (++pending == a.fold) {
#pragma unroll
            for (int o = 0; o < TILE; ++o) {
                if (o < nout) {
                    lo[0][o] = reduce128(lo[0][o], hi[0][o], c);
                    lo[1][o] = reduce128(lo[1][o], hi[1][o], c);
                    hi[0][o] = hi[1][o] = 0;
                }
            }
            pending = 0;
        }
    }
}

// The tile's outputs at (limb l, coefficient n): the sums reduced, the bias
// added to the first polynomial.
template <int TILE>
__device__ __forceinline__ void finish(const Args& a, const long long* tile, int l, long long n,
                                       const u64* c, const u64 (&lo)[2][TILE],
                                       const u64 (&hi)[2][TILE]) {
    const int nout = (int)tile[2];
    const u64 q = c[0];
    const long long half = a.J * a.L * a.N;
#pragma unroll
    for (int o = 0; o < TILE; ++o) {
        if (o < nout) {
            const long long j = tile[3 + o];
            u64 v0 = reduce128(lo[0][o], hi[0][o], c);
            if (a.bias) v0 = cred(v0 + a.bias[j * a.L + l], q);
            u64* dst = a.out + (j * a.L + l) * a.N + n;
            dst[0] = v0;
            dst[half] = reduce128(lo[1][o], hi[1][o], c);
        }
    }
}

// The C entries' arguments, checked: 0, or -2 for what the kernel does not
// take.  xstr: x's strides (k, l, n).
inline int make_args(Args& a, const void* x0, const void* x1, const long long* xstr,
                     const void* w, const void* col, const void* tiles, const void* bias,
                     const void* consts, void* out, long long T, long long P, long long J,
                     long long N, int L, int tile, int fold) {
    if (!x0 || !x1 || !xstr || !w || !col || !tiles || !consts || !out || T < 1 || P < 0 ||
        J < 1 || N < 1 || L < 1 || L > 65535 || fold < 1 || tile < 1 || tile > MAX_TILE ||
        (tile & (tile - 1)))
        return -2;
    a = Args{{(const u64*)x0, (const u64*)x1}, xstr[0], xstr[1], xstr[2], (const u64*)w,
             (const int*)col, (const long long*)tiles, (const u64*)bias, (const u64*)consts,
             (u64*)out, T, P, J, N, L, fold};
    return 0;
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

// blockIdx.x: the tile; blockIdx.y: a chunk of THREADS coefficients;
// blockIdx.z: the limb.
template <int TILE>
__global__ void __launch_bounds__(THREADS) ct_matrix_kernel(const Args a) {
    __shared__ u64 s_w[CHUNK * MAX_TILE];
    __shared__ int s_col[CHUNK];
    const long long* tile = a.tiles + (long long)blockIdx.x * TABLE;
    const int l = blockIdx.z;
    const long long n = (long long)blockIdx.y * blockDim.x + threadIdx.x;
    const long long p0 = tile[0];
    const int taps = (int)tile[1], nout = (int)tile[2];
    const u64* c = a.consts + l * CONSTS;
    const long long off = l * a.sl + n * a.sn;
    u64 lo[2][TILE], hi[2][TILE];
#pragma unroll
    for (int o = 0; o < TILE; ++o) lo[0][o] = lo[1][o] = hi[0][o] = hi[1][o] = 0;
    int pending = 0;
    for (int i0 = 0; i0 < taps; i0 += CHUNK) {
        const int count = taps - i0 < CHUNK ? taps - i0 : CHUNK;
        __syncthreads();  // the previous chunk is read
        const u64* wsrc = a.w + (l * a.P + p0 + i0) * MAX_TILE;
        for (int t = threadIdx.x; t < count * MAX_TILE; t += blockDim.x) s_w[t] = wsrc[t];
        for (int t = threadIdx.x; t < count; t += blockDim.x) s_col[t] = a.col[p0 + i0 + t];
        __syncthreads();
        if (n < a.N) accumulate<TILE>(a, s_col, s_w, count, nout, off, c, lo, hi, pending);
    }
    if (n < a.N) finish<TILE>(a, tile, l, n, c, lo, hi);
}

template <int TILE>
static void launch(const Args& a, cudaStream_t stream) {
    const int threads = a.N >= THREADS ? THREADS : (int)((a.N + 31) / 32 * 32);
    const dim3 grid((unsigned)a.T, (unsigned)((a.N + threads - 1) / threads), (unsigned)a.L);
    ct_matrix_kernel<TILE><<<grid, threads, 0, stream>>>(a);
}

// Returns -2 for an argument the kernel does not take, else the CUDA error
// of the launch.
extern "C" int ct_matrix_launch(const void* x0, const void* x1, const long long* xstr,
                                const void* w, const void* col, const void* tiles,
                                const void* bias, const void* consts, void* out, long long T,
                                long long P, long long J, long long N, int L, int tile,
                                int fold, void* stream) {
    Args a;
    if (make_args(a, x0, x1, xstr, w, col, tiles, bias, consts, out, T, P, J, N, L, tile, fold) ||
        T > 0x7fffffffLL || (N + THREADS - 1) / THREADS > 65535)
        return -2;
    switch (tile) {
        case 1: launch<1>(a, (cudaStream_t)stream); break;
        case 2: launch<2>(a, (cudaStream_t)stream); break;
        case 4: launch<4>(a, (cudaStream_t)stream); break;
        default: launch<MAX_TILE>(a, (cudaStream_t)stream);
    }
    return (int)cudaGetLastError();
}
#endif  // __CUDACC__
