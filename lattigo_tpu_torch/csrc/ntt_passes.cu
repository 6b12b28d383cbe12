// Multi-pass NTT through global memory, for rows too long for one block's
// shared memory (N = 2^15, 2^16, ...).
//
// Replaces the TPU kernel `ntt_pallas_passes` (lattigo_tpu/ops/pallas_ntt.py,
// pass body `_kernel_pass`, stage grouping `_passes`).  It computes the same
// function bit for bit: the forward negacyclic NTT (Cooley-Tukey over the
// bit-reversed merged-psi table, lazy inputs below 4q, exact output through
// BRedAdd) or the inverse (Gentleman-Sande, inputs below 4q folded twice,
// then * N^-1 with a Shoup product and a conditional subtraction).  The TPU
// kernel's batch on the 128-lane axis, its roll tail and its 128-column
// twiddle planes exist for that machine's (8,128) tiles and are not carried
// over.
//
// The log N stages split into two passes, each one round trip through
// device memory.  With C = N / 2^K:
//   column pass: the K stages of largest stride (N/2 .. C).  They couple
//     only the 2^K elements r, r + C, r + 2C, ... of one row; one thread
//     holds them in registers and runs the K stages, adjacent threads take
//     adjacent r, so every load and store is coalesced.
//   chunk pass: the log C stages of stride C/2 .. 1.  They couple only
//     elements inside one contiguous chunk of C; one block per (row, chunk)
//     runs them in shared memory, as ntt_row.cu does for a whole row.  In
//     stage m (m >= 2^K groups) local group g of chunk c uses the twiddle
//     psi[m + c * (m >> K) + g].
// The forward runs the column pass first, the inverse the chunk pass first;
// the last pass reduces exactly.
//
// Bound: bytes and 64-bit multiplies about equally (16 N bytes per row each
// way against ~10 int32 multiplies per butterfly, (N/2) log N butterflies);
// this design moves every row twice (32 N bytes), and reads twiddles from
// global memory, where the tables of the limbs in use stay in L2.
#include <cuda_runtime.h>
#include "modarith.cuh"

// consts: [L_ring, 4] = q, floor(2^128/q) >> 64, N^-1 mod q, its Shoup word.

// One thread per (row, r): the 2^K elements r + c*C, c < 2^K, in registers.
// Forward: reads src (< 4q), writes lazy values (< 4q).  Inverse: reads lazy
// values (<= 2q) and writes the exact output.  src may equal dst.
template <int K, bool INVERSE>
__global__ void column_pass(const u64* src, u64* dst, const u64* __restrict__ tw,
                            const u64* __restrict__ tws, const u64* __restrict__ consts,
                            const int* __restrict__ limbs, int L, int log_n,
                            size_t total) {
    constexpr int P = 1 << K;
    const size_t gid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (gid >= total) return;
    const int log_c = log_n - K;
    const size_t row = gid >> log_c;
    const size_t r = gid & (((size_t)1 << log_c) - 1);
    const int limb = limbs[row % L];
    const size_t n = (size_t)1 << log_n;
    const u64 q = consts[4 * limb], two_q = 2 * q;
    const u64* w = tw + (size_t)limb * n;
    const u64* ws = tws + (size_t)limb * n;
    const size_t base = row * n + r;

    u64 v[P];
#pragma unroll
    for (int c = 0; c < P; ++c) v[c] = src[base + ((size_t)c << log_c)];

    if (!INVERSE) {
        // stage m = 2^s: m groups, local stride tl (in chunks), twiddle w[m + j]
#pragma unroll
        for (int s = 0; s < K; ++s) {
            const int m = 1 << s, tl = P >> (s + 1);
#pragma unroll
            for (int j = 0; j < m; ++j) {
                const u64 W = w[m + j], WS = ws[m + j];
#pragma unroll
                for (int k = 0; k < tl; ++k) {
                    const int iu = 2 * j * tl + k, iv = iu + tl;
                    const u64 U = fold2q(v[iu], two_q);
                    const u64 V = mul_shoup(v[iv], W, WS, q);
                    v[iu] = U + V;
                    v[iv] = U + two_q - V;
                }
            }
        }
    } else {
        // stage h = 2^s, h = P/2 .. 1: local stride tl = P / (2h)
#pragma unroll
        for (int s = K - 1; s >= 0; --s) {
            const int h = 1 << s, tl = P >> (s + 1);
#pragma unroll
            for (int j = 0; j < h; ++j) {
                const u64 W = w[h + j], WS = ws[h + j];
#pragma unroll
                for (int k = 0; k < tl; ++k) {
                    const int iu = 2 * j * tl + k, iv = iu + tl;
                    const u64 U = v[iu], V = v[iv];
                    v[iu] = fold2q(U + V, two_q);
                    v[iv] = mul_shoup(U + two_q - V, W, WS, q);
                }
            }
        }
        const u64 ninv = consts[4 * limb + 2], ninvs = consts[4 * limb + 3];
#pragma unroll
        for (int c = 0; c < P; ++c) v[c] = cred(mul_shoup(v[c], ninv, ninvs, q), q);
    }

#pragma unroll
    for (int c = 0; c < P; ++c) dst[base + ((size_t)c << log_c)] = v[c];
}

// One block per (row, chunk): C contiguous elements in shared memory.
// Forward: reads lazy values (< 4q), writes the exact output.  Inverse: reads
// src (< 4q, folded twice on load), writes lazy values (<= 2q).  src may
// equal dst: a block reads its whole chunk before it writes any of it.
template <bool INVERSE>
__global__ void chunk_pass(const u64* src, u64* dst, const u64* __restrict__ tw,
                           const u64* __restrict__ tws, const u64* __restrict__ consts,
                           const int* __restrict__ limbs, int L, int log_n, int k) {
    extern __shared__ u64 s[];
    const int log_c = log_n - k;
    const int C = 1 << log_c, half = C >> 1;
    const size_t row = (size_t)blockIdx.x >> k;
    const int c = blockIdx.x & ((1 << k) - 1);
    const int limb = limbs[row % L];
    const size_t n = (size_t)1 << log_n;
    const u64 q = consts[4 * limb], two_q = 2 * q;
    const u64* w = tw + (size_t)limb * n;
    const u64* ws = tws + (size_t)limb * n;
    const size_t base = row * n + ((size_t)c << log_c);

    for (int i = threadIdx.x; i < C; i += blockDim.x) {
        u64 v = src[base + i];
        if (INVERSE) v = fold2q(fold2q(v, two_q), two_q);
        s[i] = v;
    }
    __syncthreads();

    if (!INVERSE) {
        // stride t = C/2 .. 1; stage m = N / (2t) >= 2^k, m >> k groups per chunk
        for (int log_t = log_c - 1; log_t >= 0; --log_t) {
            const int t = 1 << log_t;
            const int m = (int)(n >> (log_t + 1));
            const int tw0 = m + c * (m >> k);
            for (int i = threadIdx.x; i < half; i += blockDim.x) {
                const int g = i >> log_t, j = i & (t - 1);
                const int iu = (g << (log_t + 1)) + j, iv = iu + t;
                const u64 U = fold2q(s[iu], two_q);
                const u64 V = mul_shoup(s[iv], w[tw0 + g], ws[tw0 + g], q);
                s[iu] = U + V;
                s[iv] = U + two_q - V;
            }
            __syncthreads();
        }
        const u64 u0 = consts[4 * limb + 1];
        for (int i = threadIdx.x; i < C; i += blockDim.x) dst[base + i] = bred_add(s[i], q, u0);
    } else {
        // stride t = 1 .. C/2; stage h = N / (2t)
        for (int log_t = 0; log_t < log_c; ++log_t) {
            const int t = 1 << log_t;
            const int h = (int)(n >> (log_t + 1));
            const int tw0 = h + c * (h >> k);
            for (int i = threadIdx.x; i < half; i += blockDim.x) {
                const int g = i >> log_t, j = i & (t - 1);
                const int iu = (g << (log_t + 1)) + j, iv = iu + t;
                const u64 U = s[iu], V = s[iv];
                s[iu] = fold2q(U + V, two_q);
                s[iv] = mul_shoup(U + two_q - V, w[tw0 + g], ws[tw0 + g], q);
            }
            __syncthreads();
        }
        for (int i = threadIdx.x; i < C; i += blockDim.x) dst[base + i] = s[i];
    }
}

template <int K>
static cudaError_t launch_column(bool inverse, const u64* src, u64* dst, const u64* tw,
                                 const u64* tws, const u64* consts, const int* limbs,
                                 int L, int log_n, size_t total, cudaStream_t stream) {
    const int c = 1 << (log_n - K);
    const int threads = c < 256 ? c : 256;
    const size_t blocks = total / threads;
    if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
    if (inverse)
        column_pass<K, true><<<(unsigned)blocks, threads, 0, stream>>>(
            src, dst, tw, tws, consts, limbs, L, log_n, total);
    else
        column_pass<K, false><<<(unsigned)blocks, threads, 0, stream>>>(
            src, dst, tw, tws, consts, limbs, L, log_n, total);
    return cudaGetLastError();
}

static cudaError_t launch_column_k(int k, bool inverse, const u64* src, u64* dst,
                                   const u64* tw, const u64* tws, const u64* consts,
                                   const int* limbs, int L, int log_n, size_t total,
                                   cudaStream_t stream) {
    switch (k) {
        case 1: return launch_column<1>(inverse, src, dst, tw, tws, consts, limbs, L, log_n, total, stream);
        case 2: return launch_column<2>(inverse, src, dst, tw, tws, consts, limbs, L, log_n, total, stream);
        case 3: return launch_column<3>(inverse, src, dst, tw, tws, consts, limbs, L, log_n, total, stream);
        case 4: return launch_column<4>(inverse, src, dst, tw, tws, consts, limbs, L, log_n, total, stream);
        default: return cudaErrorInvalidValue;
    }
}

static cudaError_t launch_chunk(bool inverse, const u64* src, u64* dst, const u64* tw,
                                const u64* tws, const u64* consts, const int* limbs,
                                int rows, int L, int log_n, int k, cudaStream_t stream) {
    const int c = 1 << (log_n - k);
    const size_t smem = (size_t)c * sizeof(u64);
    const int threads = c / 2 < 512 ? c / 2 : 512;
    const size_t blocks = (size_t)rows << k;
    if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
    auto kernel = inverse ? chunk_pass<true> : chunk_pass<false>;
    // above 48 KB the dynamic shared memory has to be granted explicitly
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)blocks, threads, smem, stream>>>(src, dst, tw, tws, consts, limbs,
                                                        L, log_n, k);
    return cudaGetLastError();
}

// x, out: [rows = B*L, n] uint64 (row r carries limb table limbs[r % L]);
// k column stages, 1 <= k <= 4.  Returns the CUDA error code of the launches
// (0 = both launched).
extern "C" int ntt_passes_launch(const void* x, void* out, const void* tw, const void* tws,
                                 const void* consts, const void* limbs, int rows, int L,
                                 int log_n, int k, int inverse, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    const size_t total = (size_t)rows << (log_n - k);
    const u64 *src = (const u64*)x, *t = (const u64*)tw, *ts = (const u64*)tws,
              *cs = (const u64*)consts;
    u64* dst = (u64*)out;
    const int* lv = (const int*)limbs;
    cudaError_t err;
    if (!inverse) {
        err = launch_column_k(k, false, src, dst, t, ts, cs, lv, L, log_n, total, st);
        if (err != cudaSuccess) return (int)err;
        err = launch_chunk(false, dst, dst, t, ts, cs, lv, rows, L, log_n, k, st);
    } else {
        err = launch_chunk(true, src, dst, t, ts, cs, lv, rows, L, log_n, k, st);
        if (err != cudaSuccess) return (int)err;
        err = launch_column_k(k, true, dst, dst, t, ts, cs, lv, L, log_n, total, st);
    }
    return (int)err;
}
