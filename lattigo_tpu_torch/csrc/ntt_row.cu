// Row NTT: one thread block transforms one (batch, limb) row of N
// coefficients held in shared memory.
//
// Replaces the TPU kernel `ntt_tile` (lattigo_tpu/ops/tile_ntt.py, body
// `_kernel`).  It computes the same function bit for bit: the forward
// negacyclic NTT (Cooley-Tukey, bit-reversed merged-psi table, lazy inputs
// below 4q, exact output through BRedAdd) or the inverse (Gentleman-Sande,
// then * N^-1 and a conditional subtraction).  The TPU kernel's row and
// transposed phases and its pre-twist exist for that machine's tiles and are
// not carried over.
//
// Bound: bytes.  A row is read once and written once (16 N bytes) and does
// 5 N log N / 2 64-bit multiplies; at the batch-1 calls it serves only a
// few blocks run, so a launch is latency bound: log N stages, each ending in
// a block-wide barrier.  The design keeps the whole row in shared memory so
// device memory is touched once each way, and reads the twiddles (plain and
// Shoup words, [L_ring, N] each) from global memory, where they stay in L2.
#include <cuda_runtime.h>
#include "modarith.cuh"

// consts: [L_ring, 4] = q, floor(2^128/q) >> 64, N^-1 mod q, its Shoup word.
template <bool INVERSE>
__global__ void ntt_row_kernel(const u64* __restrict__ x, u64* __restrict__ out,
                               const u64* __restrict__ tw, const u64* __restrict__ tws,
                               const u64* __restrict__ consts,
                               const int* __restrict__ limbs, int L, int n) {
    extern __shared__ u64 s[];
    const int row = blockIdx.x;
    const int limb = limbs[row % L];
    const u64 q = consts[4 * limb], two_q = 2 * q;
    const u64* w = tw + (size_t)limb * n;
    const u64* ws = tws + (size_t)limb * n;
    const u64* src = x + (size_t)row * n;
    u64* dst = out + (size_t)row * n;
    const int half = n >> 1;

    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        u64 v = src[i];
        if (INVERSE) v = fold2q(fold2q(v, two_q), two_q);
        s[i] = v;
    }
    __syncthreads();

    if (!INVERSE) {
        // m groups of butterflies at stride t; group j uses twiddle w[m + j]
        for (int m = 1, t = half; m < n; m <<= 1, t >>= 1) {
            for (int i = threadIdx.x; i < half; i += blockDim.x) {
                const int j = i / t, k = i - j * t;
                const int iu = 2 * j * t + k, iv = iu + t;
                const u64 U = fold2q(s[iu], two_q);
                const u64 V = mul_shoup(s[iv], w[m + j], ws[m + j], q);
                s[iu] = U + V;
                s[iv] = U + two_q - V;
            }
            __syncthreads();
        }
        const u64 u0 = consts[4 * limb + 1];
        for (int i = threadIdx.x; i < n; i += blockDim.x)
            dst[i] = bred_add(s[i], q, u0);
    } else {
        for (int h = half, t = 1; h >= 1; h >>= 1, t <<= 1) {
            for (int i = threadIdx.x; i < half; i += blockDim.x) {
                const int j = i / t, k = i - j * t;
                const int iu = 2 * j * t + k, iv = iu + t;
                const u64 U = s[iu], V = s[iv];
                s[iu] = fold2q(U + V, two_q);
                s[iv] = mul_shoup(U + two_q - V, w[h + j], ws[h + j], q);
            }
            __syncthreads();
        }
        const u64 ninv = consts[4 * limb + 2], ninvs = consts[4 * limb + 3];
        for (int i = threadIdx.x; i < n; i += blockDim.x)
            dst[i] = cred(mul_shoup(s[i], ninv, ninvs, q), q);
    }
}

// x, out: [rows = B*L, n] uint64 (row r carries limb table limbs[r % L]).
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int ntt_row_launch(const void* x, void* out, const void* tw, const void* tws,
                              const void* consts, const void* limbs, int rows, int L,
                              int n, int inverse, void* stream) {
    const size_t smem = (size_t)n * sizeof(u64);
    const int threads = n / 2 < 1024 ? n / 2 : 1024;
    cudaError_t err;
    auto kernel = inverse ? ntt_row_kernel<true> : ntt_row_kernel<false>;
    // above 48 KB the dynamic shared memory has to be granted explicitly
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<rows, threads, smem, (cudaStream_t)stream>>>(
        (const u64*)x, (u64*)out, (const u64*)tw, (const u64*)tws, (const u64*)consts,
        (const int*)limbs, L, n);
    return (int)cudaGetLastError();
}
