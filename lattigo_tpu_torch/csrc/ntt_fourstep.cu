// Four-step negacyclic NTT with exact int8 tensor-core digit products.
//
// Replaces the TPU kernel `ntt_mxu` (lattigo_tpu/ops/mxu_ntt.py, body
// `_compute_block`).  With N = n1 x 128 and x2d[j1, j2] the transform is
//
//     out2d = ((M_rows @ x2d) * T) @ M_lanes   (mod q)        forward
//     out2d = M_rows @ ((x2d @ M_lanes) * T)   (mod q)        inverse
//
// Each modular product is one s8 x s8 -> s32 product over byte digits: the
// data enter as 8 digit planes (u ^ 0x80), the matrices hold 8 x 8 balanced
// digit blocks, and the result leaves as 8 digit planes that are recombined
// in uint64.  The products run here on the int8 tensor cores
// (nvcuda::wmma 16x16x16 s8 fragments, s32 accumulators); the recombination,
// the twiddle or the final exact reduction follow in the same kernel in
// 64-bit registers.
//
// This version launches two kernels per transform (first product + twiddle,
// second product + final reduction) and keeps the [rows, n1, 128]
// intermediate in device memory.  One block serves one (poly, limb) row and
// one 16-wide tile of it, so no batch needs padding.
//
// Bound: by the roofline, bytes (16 N per row against
// 2*(8 n1)^2*128 + 2*n1*1024^2 int8 operations).  This version is held back
// by L2 traffic instead: every block streams its whole digit matrix for one
// tile.  The matrices are stored tile-major (each 16x16 fragment contiguous
// and 256-byte aligned) so that a fragment load is one aligned 256-byte read.
#include <cuda_runtime.h>
#include <mma.h>
#include "modarith.cuh"

using namespace nvcuda;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, int> FragC;

constexpr int DIG = 8;      // byte digits of a 64-bit word
constexpr int N2 = 128;     // lane-axis transform length
constexpr int TILE = 16;    // fragment edge
constexpr int FRAG = TILE * TILE;
constexpr int LANES_WARPS = N2 / TILE;  // one warp per 16-column tile
constexpr int ROWS_MAX_WARPS = 8;

// consts: [L_ring, 8] = q, 2^40 mod q, its Shoup word, final offset
// correction, floor(2^128/q) >> 64.
struct LimbConsts {
    u64 q, c40, c40s, cf, u0;
};

__device__ __forceinline__ LimbConsts load_consts(const u64* consts, int limb) {
    const u64* c = consts + 8 * limb;
    return {c[0], c[1], c[2], c[3], c[4]};
}

// sum_e plane_e 2^{8e}, lazily reduced through one Shoup product by 2^40.
__device__ __forceinline__ u64 combine(const u64 p[DIG], const LimbConsts& k) {
    const u64 lo = p[0] + (p[1] << 8) + (p[2] << 16) + (p[3] << 24) + (p[4] << 32);
    const u64 hi = p[5] + (p[6] << 8) + (p[7] << 16);
    return lo + mul_shoup(hi, k.c40, k.c40s, k.q);
}

// The epilogue of either product for one element: middle twiddle (lazy) or
// the final exact reduction.  tw: [3, n] = twiddle, Shoup word, correction.
template <bool FINAL>
__device__ __forceinline__ u64 epilogue(const u64 p[DIG], const LimbConsts& k,
                                        const u64* __restrict__ tw, int n, int pos) {
    const u64 v = combine(p, k);
    if (FINAL) return bred_add(v + k.cf, k.q, k.u0);
    return mul_shoup(v, tw[pos], tw[n + pos], k.q) + tw[2 * n + pos];
}

// Rows product: out[a, j2] = sum_b M[a, b] data[b, j2], a, b in [0, n1).
// grid (rows, 128/16); block: min(n1/16, 8) warps, each a 16-row tile.
// Shared memory: the digit operand [(d, b)][16] s8, then 8 fragments of s32
// scratch per warp.
template <bool FINAL>
__global__ void rows_mm_kernel(const u64* __restrict__ x, u64* __restrict__ out,
                               const signed char* __restrict__ m_rows,
                               const int* __restrict__ c_rows,
                               const u64* __restrict__ ttab, const u64* __restrict__ consts,
                               const int* __restrict__ limbs, int L, int n1) {
    extern __shared__ __align__(256) unsigned char smem[];
    const int K = DIG * n1, n = n1 * N2;
    signed char* dsm = reinterpret_cast<signed char*>(smem);
    int* scratch = reinterpret_cast<int*>(smem + (size_t)K * TILE);

    const int row = blockIdx.x, c0 = blockIdx.y * TILE;
    const int limb = limbs[row % L];
    const u64* src = x + (size_t)row * n;
    u64* dst = out + (size_t)row * n;

    for (int i = threadIdx.x; i < n1 * TILE; i += blockDim.x) {
        const int b = i >> 4, jj = i & 15;
        const u64 v = src[b * N2 + c0 + jj];
#pragma unroll
        for (int d = 0; d < DIG; ++d)
            dsm[(d * n1 + b) * TILE + jj] = (signed char)(((v >> (8 * d)) & 255) ^ 0x80);
    }
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
    const int kt = K / TILE;  // fragments along either edge of the matrix
    const signed char* M = m_rows + (size_t)limb * K * K;
    const int* corr = c_rows + (size_t)limb * K;
    const u64* tw = ttab + (size_t)limb * 3 * n;
    const LimbConsts k = load_consts(consts, limb);
    int* sc = scratch + warp * DIG * FRAG;

    for (int rt = warp; rt < n1 / TILE; rt += nwarps) {
        FragC acc[DIG];
#pragma unroll
        for (int e = 0; e < DIG; ++e) wmma::fill_fragment(acc[e], 0);
        for (int ks = 0; ks < kt; ++ks) {
            FragB fb;
            wmma::load_matrix_sync(fb, dsm + ks * FRAG, TILE);
#pragma unroll
            for (int e = 0; e < DIG; ++e) {
                FragA fa;
                const int tile_row = e * (n1 / TILE) + rt;
                wmma::load_matrix_sync(fa, M + ((size_t)tile_row * kt + ks) * FRAG, TILE);
                wmma::mma_sync(acc[e], fa, fb, acc[e]);
            }
        }
#pragma unroll
        for (int e = 0; e < DIG; ++e)
            wmma::store_matrix_sync(sc + e * FRAG, acc[e], TILE, wmma::mem_row_major);
        __syncwarp();
        for (int idx = lane; idx < FRAG; idx += 32) {
            const int a = rt * TILE + (idx >> 4), jj = idx & 15;
            u64 p[DIG];
#pragma unroll
            for (int e = 0; e < DIG; ++e)
                p[e] = (u64)(unsigned)(sc[e * FRAG + idx] + corr[e * n1 + a]);
            const int pos = a * N2 + c0 + jj;
            dst[pos] = epilogue<FINAL>(p, k, tw, n, pos);
        }
        __syncwarp();
    }
}

// Lanes product: out[r, c] = sum_j data[r, j] M[j, c], j, c in [0, 128).
// grid (rows, n1/16); block: 8 warps, warp w owns columns [16 w, 16 w + 16).
// Shared memory: the digit operand of 16 data rows, tile-major
// [(d, j)/16][16][16] s8, then 8 fragments of s32 scratch per warp.
template <bool FINAL>
__global__ void lanes_mm_kernel(const u64* __restrict__ x, u64* __restrict__ out,
                                const signed char* __restrict__ m_lanes,
                                const int* __restrict__ c_lanes,
                                const u64* __restrict__ ttab, const u64* __restrict__ consts,
                                const int* __restrict__ limbs, int L, int n1) {
    extern __shared__ __align__(256) unsigned char smem[];
    constexpr int K = DIG * N2, KT = K / TILE;
    const int n = n1 * N2;
    signed char* dsm = reinterpret_cast<signed char*>(smem);
    int* scratch = reinterpret_cast<int*>(smem + (size_t)K * TILE);

    const int row = blockIdx.x, r0 = blockIdx.y * TILE;
    const int limb = limbs[row % L];
    const u64* src = x + (size_t)row * n;
    u64* dst = out + (size_t)row * n;

    for (int i = threadIdx.x; i < TILE * N2; i += blockDim.x) {
        const int rr = i >> 7, j = i & (N2 - 1);
        const u64 v = src[(r0 + rr) * N2 + j];
#pragma unroll
        for (int d = 0; d < DIG; ++d) {
            const int kk = d * N2 + j;
            dsm[(kk >> 4) * FRAG + rr * TILE + (kk & 15)] =
                (signed char)(((v >> (8 * d)) & 255) ^ 0x80);
        }
    }
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const signed char* M = m_lanes + (size_t)limb * K * K;
    const int* corr = c_lanes + (size_t)limb * K;
    const u64* tw = ttab + (size_t)limb * 3 * n;
    const LimbConsts k = load_consts(consts, limb);
    int* sc = scratch + warp * DIG * FRAG;

    FragC acc[DIG];
#pragma unroll
    for (int e = 0; e < DIG; ++e) wmma::fill_fragment(acc[e], 0);
    for (int ks = 0; ks < KT; ++ks) {
        FragA fa;
        wmma::load_matrix_sync(fa, dsm + ks * FRAG, TILE);
#pragma unroll
        for (int e = 0; e < DIG; ++e) {
            FragB fb;
            const int tile_col = e * LANES_WARPS + warp;
            wmma::load_matrix_sync(fb, M + ((size_t)ks * KT + tile_col) * FRAG, TILE);
            wmma::mma_sync(acc[e], fa, fb, acc[e]);
        }
    }
#pragma unroll
    for (int e = 0; e < DIG; ++e)
        wmma::store_matrix_sync(sc + e * FRAG, acc[e], TILE, wmma::mem_row_major);
    __syncwarp();
    for (int idx = lane; idx < FRAG; idx += 32) {
        const int r = r0 + (idx >> 4), c = warp * TILE + (idx & 15);
        u64 p[DIG];
#pragma unroll
        for (int e = 0; e < DIG; ++e)
            p[e] = (u64)(unsigned)(sc[e * FRAG + idx] + corr[e * N2 + c]);
        const int pos = r * N2 + c;
        dst[pos] = epilogue<FINAL>(p, k, tw, n, pos);
    }
}

template <typename Kernel>
static cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                          const u64* x, u64* out, const signed char* m, const int* c,
                          const u64* ttab, const u64* consts, const int* limbs, int L, int n1) {
    // above 48 KB the dynamic shared memory has to be granted explicitly
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, threads, smem, stream>>>(x, out, m, c, ttab, consts, limbs, L, n1);
    return cudaGetLastError();
}

// x, mid, out: [rows = B*L, n1, 128] uint64 (row r carries limb table
// limbs[r % L]); m_rows [L_ring, 8 n1/16, 8 n1/16, 16, 16] s8 and m_lanes
// [L_ring, 64, 64, 16, 16] s8 tile-major; c_rows [L_ring, 8 n1] and c_lanes
// [L_ring, 1024] s32; ttab [L_ring, 3, n1*128] u64; consts [L_ring, 8] u64.
// Returns the CUDA error code of the launches (0 = both launched).
extern "C" int ntt_fourstep_launch(const void* x, void* mid, void* out, const void* m_rows,
                                   const void* c_rows, const void* m_lanes, const void* c_lanes,
                                   const void* ttab, const void* consts, const void* limbs,
                                   int rows, int L, int n1, int inverse, void* stream_) {
    cudaStream_t stream = (cudaStream_t)stream_;
    const int rows_warps = n1 / TILE < ROWS_MAX_WARPS ? n1 / TILE : ROWS_MAX_WARPS;
    const size_t rows_smem = (size_t)DIG * n1 * TILE + (size_t)rows_warps * DIG * FRAG * sizeof(int);
    const size_t lanes_smem = (size_t)DIG * N2 * TILE + (size_t)LANES_WARPS * DIG * FRAG * sizeof(int);
    const dim3 rows_grid(rows, N2 / TILE), lanes_grid(rows, n1 / TILE);
    const u64* xs = (const u64*)x;
    u64* ms = (u64*)mid;
    u64* os = (u64*)out;
    const signed char* mr = (const signed char*)m_rows;
    const signed char* ml = (const signed char*)m_lanes;
    const int* cr = (const int*)c_rows;
    const int* cl = (const int*)c_lanes;
    const u64* tt = (const u64*)ttab;
    const u64* cs = (const u64*)consts;
    const int* lv = (const int*)limbs;
    cudaError_t err;
    if (!inverse) {
        err = launch(rows_mm_kernel<false>, rows_grid, rows_warps * 32, rows_smem, stream,
                     xs, ms, mr, cr, tt, cs, lv, L, n1);
        if (err != cudaSuccess) return (int)err;
        err = launch(lanes_mm_kernel<true>, lanes_grid, LANES_WARPS * 32, lanes_smem, stream,
                     (const u64*)ms, os, ml, cl, tt, cs, lv, L, n1);
    } else {
        err = launch(lanes_mm_kernel<false>, lanes_grid, LANES_WARPS * 32, lanes_smem, stream,
                     xs, ms, ml, cl, tt, cs, lv, L, n1);
        if (err != cudaSuccess) return (int)err;
        err = launch(rows_mm_kernel<true>, rows_grid, rows_warps * 32, rows_smem, stream,
                     (const u64*)ms, os, mr, cr, tt, cs, lv, L, n1);
    }
    return (int)err;
}
