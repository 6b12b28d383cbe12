// Row NTT: one thread block transforms whole rows of N = 2^8 .. 2^14
// coefficients of one limb in its shared memory, in rounds of up to three
// radix-2 stages held in registers.
//
// Replaces the TPU kernel `ntt_tile` (lattigo_tpu/ops/tile_ntt.py:348, body
// `_kernel` :185).  It computes the same function bit for bit: the forward
// negacyclic NTT (Cooley-Tukey over the bit-reversed merged-psi table, lazy
// inputs below 4q, exact output through BRedAdd) or the inverse
// (Gentleman-Sande, inputs below 4q folded twice, then * N^-1 with a Shoup
// product and a conditional subtraction).  The TPU kernel's row and
// transposed phases and its pre-twist exist for that machine's (8,128) tiles
// and are not carried over.
//
// Bound on the H100: the larger of the bytes (16 N a row, read once and
// written once, plus 16 N of (plain, Shoup) twiddle pairs a limb, at
// 3.35 TB/s) and the operations ((N/2) log N Shoup butterflies of about 10
// int32 multiplies, at 16.75 T multiplies/s).  At [72, 3, 16384] the bytes
// bound it (0.0171 ms against 0.0148).  What the design does about it:
//   * each coefficient crosses device memory once each way; the stages run
//     between, in shared memory and registers;
//   * a round loads the 2^R elements i0 + k 2^e (k < 2^R) of a unit into
//     one thread's registers, runs R stages on them (strides 2^(e+R-1) ..
//     2^e forward, 2^e .. 2^(e+R-1) inverse) and stores them back: one
//     block barrier a round, not a stage (5 at N = 16384, not 14).  Full
//     rounds sit at e = 0, RADIX, 2 RADIX, ...; the remainder of
//     log N mod RADIX stages at the largest strides (a remainder of one
//     stage and the next full round as two rounds of two).  Indices are
//     shifts and masks: no integer division;
//   * the forward's first round reads device memory and the inverse's last
//     round writes it directly (their strides are >= 2^5, so a warp reads
//     or writes 256 contiguous bytes an element); the other end of each
//     transform is a contiguous pass through shared memory with IN_FLIGHT
//     accesses a thread in flight;
//   * element b of a block lives at word b ^ ((b >> SWZ) & 15): every warp
//     access of every round and of the contiguous passes touches each bank
//     pair once per half-warp (checked by enumeration on the CPU);
//   * one 16-byte load gives a twiddle and its Shoup word;
//   * at N <= 2048 a block holds up to 4096 / N rows of one limb, which
//     share the twiddles in L1 (the caller's plan takes several only where
//     the transform still has two blocks an SM: below that, spreading the
//     rows is faster); the grid is limb-major (blockIdx.y = limb
//     position), so the blocks that run together read one limb's table,
//     which stays in L2;
//   * a row of 16384 is 128 KB, one block an SM whatever its threads: the
//     plan gives it 1024 threads (64 registers), 6 % faster than 512.
#include <cuda_runtime.h>
#include <cstdint>
#include "modarith.cuh"

constexpr int RADIX = 3;  // stages a round: a thread holds 2^RADIX elements
constexpr int SWZ = 3;    // swizzle shift of the shared-memory word
constexpr int MAX_THREADS = 1024;
constexpr int MIN_LOG_N = 8, MAX_LOG_N = 14;
constexpr int BLOCK_WORDS = 1 << 14;  // 128 KB of shared memory at most
constexpr int IN_FLIGHT = 8;  // loads a thread issues before it uses one, in the contiguous passes

struct Args {
    const u64* x;           // [B*L, N]: row b*L + l carries limb table limbs[l]
    u64* y;                 // [B*L, N]; not x
    const ulonglong2* tw;   // [L_ring, N] of (plain, Shoup) twiddle pairs
    const u64* consts;      // [L_ring, 4]: q, floor(2^128/q) >> 64, N^-1, its Shoup word
    const int* limbs;
    int batch, L, log_n, log_rows;
};

// The shared-memory word of block element b (a bijection).
__device__ __forceinline__ int swz(int b) { return b ^ ((b >> SWZ) & 15); }

// What every round of a block shares.
struct Block {
    u64* s;
    const u64* src;  // row b0 of this limb in x
    u64* dst;        // row b0 of this limb in y
    size_t row_stride;  // L N: from row b to b + 1 of one limb
    const ulonglong2* w;
    u64 q, two_q, ninv, ninvs;
    int rows, log_n;  // rows of the block that exist (the last block is ragged)
};

// One round of R stages at stride exponent e.  Unit u = (r, G, j), j < 2^e,
// holds the 2^R elements i0 + k 2^e of row r, i0 = G 2^(e+R) + j; in
// forward stage st its pairs at distance 2^(R-1-st) in k share the group
// G 2^st + (k >> (R - st)), whose twiddle is w[m + group] for the stage's
// m groups; the inverse mirrors it.  FROM_GLOBAL reads the unit from x,
// TO_GLOBAL writes it to y times N^-1, exactly reduced.
template <int R, bool INVERSE, bool FROM_GLOBAL, bool TO_GLOBAL>
__device__ __forceinline__ void row_round(const Block& blk, int e) {
    constexpr int E = 1 << R;
    const int log_n = blk.log_n, log_units = log_n - R;
    const int units = blk.rows << log_units;
    for (int u = threadIdx.x; u < units; u += blockDim.x) {
        const int r = u >> log_units, v = u & ((1 << log_units) - 1);
        const int G = v >> e;
        const int i0 = (G << (e + R)) + (v & ((1 << e) - 1));
        const int b = (r << log_n) + i0;  // block element of k = 0
        const size_t g = r * blk.row_stride + i0;  // its offset from row b0 in x and y
        u64 x[E];
#pragma unroll
        for (int k = 0; k < E; ++k)
            x[k] = FROM_GLOBAL ? blk.src[g + (k << e)] : blk.s[swz(b + (k << e))];
#pragma unroll
        for (int st = 0; st < R; ++st) {
            const int log_t = INVERSE ? e + st : e + R - 1 - st;
            const int m = 1 << (log_n - log_t - 1);  // groups of the stage
            const int d = INVERSE ? 1 << st : 1 << (R - 1 - st);  // pair distance in k
            const int ng = E / (2 * d);  // groups of the stage in the unit
            const ulonglong2* __restrict__ wg = blk.w + m + G * ng;
#pragma unroll
            for (int gg = 0; gg < ng; ++gg) {
                const ulonglong2 t = __ldg(wg + gg);
#pragma unroll
                for (int kk = 0; kk < d; ++kk) {
                    const int i = gg * 2 * d + kk, j = i + d;
                    const u64 U = x[i], V = x[j];
                    if (!INVERSE) {
                        const u64 Uf = fold2q(U, blk.two_q), Vw = mul_shoup(V, t.x, t.y, blk.q);
                        x[i] = Uf + Vw;
                        x[j] = Uf + blk.two_q - Vw;
                    } else {
                        x[i] = fold2q(U + V, blk.two_q);
                        x[j] = mul_shoup(U + blk.two_q - V, t.x, t.y, blk.q);
                    }
                }
            }
        }
#pragma unroll
        for (int k = 0; k < E; ++k) {
            if (TO_GLOBAL)
                blk.dst[g + (k << e)] = cred(mul_shoup(x[k], blk.ninv, blk.ninvs, blk.q), blk.q);
            else
                blk.s[swz(b + (k << e))] = x[k];
        }
    }
    if (!TO_GLOBAL) __syncthreads();
}

// The round of the remaining `rem` (1 .. R) stages.
template <int R, bool INVERSE, bool FROM_GLOBAL, bool TO_GLOBAL>
__device__ __forceinline__ void rem_round(const Block& blk, int rem, int e) {
    if constexpr (R >= 1) {
        if (rem == R) row_round<R, INVERSE, FROM_GLOBAL, TO_GLOBAL>(blk, e);
        else rem_round<R - 1, INVERSE, FROM_GLOBAL, TO_GLOBAL>(blk, rem, e);
    }
}

// Grid: (ceil(B / rows), L); block (c, l) transforms rows b = c rows ..
// c rows + rows - 1 of limb position l.  Forward: x below 4q, y exact;
// inverse likewise.
template <bool INVERSE>
__global__ void __launch_bounds__(MAX_THREADS) ntt_row(const Args a) {
    extern __shared__ u64 s[];
    const int log_n = a.log_n, l = blockIdx.y;
    const int b0 = blockIdx.x << a.log_rows;
    const int limb = __ldg(a.limbs + l);
    const u64* __restrict__ consts = a.consts + 4 * limb;
    const size_t row_stride = (size_t)a.L << log_n;
    const size_t first = ((size_t)b0 * a.L + l) << log_n;
    Block blk;
    blk.s = s;
    blk.src = a.x + first;
    blk.dst = a.y + first;
    blk.row_stride = row_stride;
    blk.w = a.tw + ((size_t)limb << log_n);
    blk.q = __ldg(consts);
    blk.two_q = 2 * blk.q;
    blk.ninv = __ldg(consts + 2);
    blk.ninvs = __ldg(consts + 3);
    blk.rows = min(1 << a.log_rows, a.batch - b0);
    blk.log_n = log_n;
    const int words = blk.rows << log_n, mask = (1 << log_n) - 1;
    // The rounds, largest strides first: log N mod RADIX stages, then full
    // rounds down to e = 0; a remainder of one stage is merged with the
    // next full round and split evenly (2 + 2 for RADIX 3), so no round
    // holds only two elements a thread.
    const int rem = log_n % RADIX;
    constexpr int A = (RADIX + 1) / 2, B = RADIX + 1 - A;  // the split rounds
    const bool split = RADIX > 1 && rem == 1;
    const int full_top = split ? log_n - RADIX - 1 : log_n - rem;  // above the full rounds

    if (!INVERSE) {
        // the first round reads x: its strides are >= 2^5, so a warp reads
        // 256 contiguous bytes an element
        if (split) {
            row_round<A, false, true, false>(blk, full_top + B);
            row_round<B, false, false, false>(blk, full_top);
        } else if (rem) {
            rem_round<RADIX - 1, false, true, false>(blk, rem, full_top);
        } else {
            row_round<RADIX, false, true, false>(blk, full_top - RADIX);
        }
        for (int e = full_top - RADIX - (split || rem ? 0 : RADIX); e >= 0; e -= RADIX)
            row_round<RADIX, false, false, false>(blk, e);
        const u64 u0 = __ldg(consts + 1);
        for (int b0 = threadIdx.x; b0 < words; b0 += IN_FLIGHT * blockDim.x) {
            u64 v[IN_FLIGHT];
#pragma unroll
            for (int k = 0; k < IN_FLIGHT; ++k) {
                const int b = b0 + k * blockDim.x;
                if (b < words) v[k] = bred_add(s[swz(b)], blk.q, u0);
            }
#pragma unroll
            for (int k = 0; k < IN_FLIGHT; ++k) {
                const int b = b0 + k * blockDim.x;
                if (b < words) blk.dst[(b >> log_n) * row_stride + (b & mask)] = v[k];
            }
        }
    } else {
        // IN_FLIGHT loads a thread before the first use
        for (int b0 = threadIdx.x; b0 < words; b0 += IN_FLIGHT * blockDim.x) {
            u64 v[IN_FLIGHT];
#pragma unroll
            for (int k = 0; k < IN_FLIGHT; ++k) {
                const int b = b0 + k * blockDim.x;
                if (b < words) v[k] = blk.src[(b >> log_n) * row_stride + (b & mask)];
            }
#pragma unroll
            for (int k = 0; k < IN_FLIGHT; ++k) {
                const int b = b0 + k * blockDim.x;
                if (b < words) s[swz(b)] = fold2q(fold2q(v[k], blk.two_q), blk.two_q);
            }
        }
        __syncthreads();
        // the last round writes y (strides >= 2^5 again)
        const int last = split || rem ? -1 : full_top - RADIX;
        for (int e = 0; e < full_top; e += RADIX) {
            if (e == last) row_round<RADIX, true, false, true>(blk, e);
            else row_round<RADIX, true, false, false>(blk, e);
        }
        if (split) {
            row_round<B, true, false, false>(blk, full_top);
            row_round<A, true, false, true>(blk, full_top + B);
        } else if (rem) {
            rem_round<RADIX - 1, true, false, true>(blk, rem, full_top);
        }
    }
}

constexpr int MAX_DEVICES = 64;
// Per device and direction: the dynamic shared memory has been granted.
static bool g_granted[MAX_DEVICES][2];

// x, out: [rows = B*L, N] uint64 (row b*L + l carries limb table limbs[l]);
// tw: [L_ring, N, 2] (plain, Shoup) pairs; consts: [L_ring, 4].  The launch
// plan comes from the caller: `rows_per_block` rows of one limb a block
// (a power of two), `threads` a block, `smem` = 8 N rows_per_block bytes.
// Returns 0 when the kernel launched, a CUDA error code when a call failed,
// -2 when the plan is not one the kernel takes.  Nothing falls back.
extern "C" int ntt_row_launch(const void* x, void* out, const void* tw, const void* consts,
                              const void* limbs, int rows, int L, int log_n,
                              int rows_per_block, int threads, int smem, int inverse,
                              void* stream) {
    if (log_n < MIN_LOG_N || log_n > MAX_LOG_N || L < 1 || L > 65535 || rows < L ||
        rows % L != 0 || rows_per_block < 1 || (rows_per_block & (rows_per_block - 1)) ||
        (rows_per_block << log_n) > BLOCK_WORDS ||
        smem != (rows_per_block << log_n) * (int)sizeof(u64) || threads < 32 ||
        threads > MAX_THREADS || threads % 32 != 0)
        return -2;
    const int batch = rows / L;
    int log_rows = 0;
    while ((1 << log_rows) < rows_per_block) ++log_rows;
    const Args a{(const u64*)x, (u64*)out, (const ulonglong2*)tw, (const u64*)consts,
                 (const int*)limbs, batch, L, log_n, log_rows};
    const dim3 grid((unsigned)((batch + rows_per_block - 1) / rows_per_block), (unsigned)L);
    const auto kernel = inverse ? ntt_row<true> : ntt_row<false>;

    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess && dev >= MAX_DEVICES) err = cudaErrorInvalidDevice;
    const int dir = inverse != 0;
    if (err == cudaSuccess && !g_granted[dev][dir]) {
        // above 48 KB dynamic shared memory has to be granted explicitly:
        // the most any plan asks, once per device and direction
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   BLOCK_WORDS * (int)sizeof(u64));
        g_granted[dev][dir] = err == cudaSuccess;
    }
    if (err == cudaSuccess) {
        kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(a);
        err = cudaGetLastError();
    } else {
        cudaGetLastError();  // clear the error, the caller raises
    }
    return (int)err;
}
