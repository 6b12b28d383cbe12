// Long-row NTT: one thread-block-cluster launch per transform, one round trip
// through device memory, for rows of N = 2^10 .. 2^17.
//
// Replaces the TPU kernel `ntt_pallas_passes` (lattigo_tpu/ops/pallas_ntt.py,
// pass body `_kernel_pass`, stage grouping `_passes`).  It computes the same
// function bit for bit: the forward negacyclic NTT (Cooley-Tukey over the
// bit-reversed merged-psi table, lazy inputs below 4q, exact output through
// BRedAdd) or the inverse (Gentleman-Sande, inputs below 4q folded twice,
// then * N^-1 with a Shoup product and a conditional subtraction).  The TPU
// kernel's batch on the 128-lane axis, its roll tail and its 128-column
// twiddle planes exist for that machine's (8,128) tiles and are not carried
// over; nor are its several passes through memory: an H100 block holds at
// most 227 KB, not a 512 KB row, but a cluster of P = 2^K blocks holds it.
//
// A cluster of P blocks transforms one row; block c owns the contiguous
// chunk c of C = N / P coefficients in its shared memory.  The log N stages
// split in two groups:
//   column stages: the K stages of largest stride (N/2 .. C).  They couple
//     only the P elements r, r + C, r + 2C, ... of one row (the column r);
//     one thread holds them in registers and runs the K stages with the
//     twiddles w[m + j].  Block c takes the columns [c C/P, (c+1) C/P),
//     adjacent threads adjacent r, so each warp load or store of device
//     memory is 256 contiguous bytes.
//   chunk stages: the log C stages of stride C/2 .. 1.  They couple only
//     elements inside one chunk; block c runs them in its shared memory.  In
//     stage m (m >= P groups) local group g of chunk c uses the twiddle
//     psi[m + c * (m >> K) + g].  They run in rounds of up to 3 stages: a
//     thread loads the 8 elements i0 + k 2^e (k < 8) of a unit into
//     registers, runs the round's 3 stages (strides 2^(e+2), 2^(e+1), 2^e)
//     on them and stores them back, so a round costs one block barrier and
//     one load and store per element instead of three.  Full rounds sit at
//     e = 0, 3, 6, ...; the remainder of log C mod 3 stages at the largest
//     strides.
// Between the two groups, value c of column r moves to block c's shared
// memory at offset r (forward: column stages first, the stores go to the
// other blocks through distributed shared memory; inverse: chunk stages
// first, the loads come from them), with a cluster barrier between.  The
// lazy values stay below 4q there; the last group reduces exactly.
// Element i of a chunk sits at word swz(i) = i ^ ((i >> 3) & 15) of shared
// memory: with the rounds above, every warp access (contiguous, or 8
// elements at stride 2^e) touches each bank pair once per half-warp.
//
// Bound: bytes and 64-bit multiplies about equally (16 N bytes per row
// against ~10 int32 multiplies per butterfly, (N/2) log N butterflies).  The
// design reads and writes each coefficient in device memory once; the
// exchange stays on chip.  The grid is limb-major, so the clusters that run
// at the same time read one limb's twiddle tables, which stay in L2.
#include <cuda_runtime.h>
#include <cstdint>
#include "modarith.cuh"

// consts: [L_ring, 4] = q, floor(2^128/q) >> 64, N^-1 mod q, its Shoup word.

constexpr int MAX_THREADS = 512;
constexpr int MAX_K = 3;  // clusters of at most 8 blocks, the portable size
constexpr int MIN_LOG_N = 10, MAX_LOG_N = 17;

// --- cluster primitives (PTX ISA: barrier.cluster, mapa, st/ld.shared::cluster)

// Arrive without ordering memory: only says this block has started.
__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
// Arrive with release semantics: this thread's earlier accesses are visible
// to every thread of the cluster that has waited on the barrier.
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return r;
}
// The address of the same shared-memory offset in block `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
    uint32_t out;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
    return out;
}
__device__ __forceinline__ void st_cluster(uint32_t addr, u64 v) {
    asm volatile("st.shared::cluster.u64 [%0], %1;\n" ::"r"(addr), "l"(v) : "memory");
}
__device__ __forceinline__ u64 ld_cluster(uint32_t addr) {
    u64 v;
    asm volatile("ld.shared::cluster.u64 %0, [%1];\n" : "=l"(v) : "r"(addr) : "memory");
    return v;
}

struct Args {
    const u64* x;  // [B*L, N]: row b*L + l carries limb table limbs[l]
    u64* y;        // [B*L, N]; may equal x
    const u64* tw;
    const u64* tws;
    const u64* consts;
    const int* limbs;
    int batch, L, log_n;
};

// The shared-memory word of chunk element i (a bijection inside each 16).
__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 3) & 15); }

// The twiddles tw0 .. tw0 + ng - 1 of one stage of a unit (plain and Shoup
// words), tw0 a multiple of ng: one 8-byte load each for ng = 1, else
// 16-byte loads.
template <int NMAX>
__device__ __forceinline__ void load_twiddles(const u64* __restrict__ w,
                                              const u64* __restrict__ ws, int tw0, int ng,
                                              u64 (&W)[NMAX], u64 (&WS)[NMAX]) {
    if (ng == 1) {
        W[0] = __ldg(w + tw0);
        WS[0] = __ldg(ws + tw0);
        return;
    }
#pragma unroll
    for (int p = 0; p < NMAX / 2; ++p) {
        if (2 * p < ng) {
            const ulonglong2 a = __ldg(reinterpret_cast<const ulonglong2*>(w + tw0) + p);
            const ulonglong2 b = __ldg(reinterpret_cast<const ulonglong2*>(ws + tw0) + p);
            W[2 * p] = a.x;
            W[2 * p + 1] = a.y;
            WS[2 * p] = b.x;
            WS[2 * p + 1] = b.y;
        }
    }
}

// One round of R chunk stages: forward strides 2^(e+R-1) .. 2^e, inverse
// 2^e .. 2^(e+R-1).  Unit u = (G, j), j < 2^e, holds the 2^R elements
// i0 + k 2^e of chunk c, i0 = G 2^(e+R) + j; in forward stage st its pairs
// at distance 2^(R-1-st) in k share the group G 2^st + (k >> (R - st)).
template <int K, int R, bool INVERSE>
__device__ __forceinline__ void chunk_round(u64* s, int e, int log_c, int log_n, int c,
                                            const u64* __restrict__ w,
                                            const u64* __restrict__ ws, u64 q, u64 two_q) {
    constexpr int E = 1 << R;
    const int units = 1 << (log_c - R);
    for (int u = threadIdx.x; u < units; u += blockDim.x) {
        const int G = u >> e;
        const int i0 = (G << (e + R)) + (u & ((1 << e) - 1));
        u64 x[E];
#pragma unroll
        for (int k = 0; k < E; ++k) x[k] = s[swz(i0 + (k << e))];
#pragma unroll
        for (int st = 0; st < R; ++st) {
            const int log_t = INVERSE ? e + st : e + R - 1 - st;
            const int m = 1 << (log_n - log_t - 1);  // groups of the stage
            const int d = INVERSE ? 1 << st : 1 << (R - 1 - st);  // pair distance in k
            const int ng = E / (2 * d);  // groups of the stage in the unit
            const int tw0 = m + c * (m >> K) + G * ng;
            u64 W[E / 2], WS[E / 2];
            load_twiddles<E / 2>(w, ws, tw0, ng, W, WS);
#pragma unroll
            for (int gg = 0; gg < ng; ++gg) {
#pragma unroll
                for (int kk = 0; kk < d; ++kk) {
                    const int a = gg * 2 * d + kk, b = a + d;
                    const u64 U = x[a], V = x[b];
                    if (!INVERSE) {
                        const u64 Uf = fold2q(U, two_q), Vw = mul_shoup(V, W[gg], WS[gg], q);
                        x[a] = Uf + Vw;
                        x[b] = Uf + two_q - Vw;
                    } else {
                        x[a] = fold2q(U + V, two_q);
                        x[b] = mul_shoup(U + two_q - V, W[gg], WS[gg], q);
                    }
                }
            }
        }
#pragma unroll
        for (int k = 0; k < E; ++k) s[swz(i0 + (k << e))] = x[k];
    }
    __syncthreads();
}

// All log C chunk stages of chunk c, in rounds (forward from the largest
// stride down, inverse from the smallest up).
template <int K, bool INVERSE>
__device__ __forceinline__ void chunk_stages(u64* s, int log_c, int log_n, int c,
                                             const u64* __restrict__ w,
                                             const u64* __restrict__ ws, u64 q, u64 two_q) {
    const int rem = log_c % 3, top = log_c - rem;
    if (!INVERSE) {
        if (rem == 1) chunk_round<K, 1, false>(s, top, log_c, log_n, c, w, ws, q, two_q);
        if (rem == 2) chunk_round<K, 2, false>(s, top, log_c, log_n, c, w, ws, q, two_q);
    }
    for (int i = 0; i < top; i += 3) {
        const int e = INVERSE ? i : top - 3 - i;
        chunk_round<K, 3, INVERSE>(s, e, log_c, log_n, c, w, ws, q, two_q);
    }
    if (INVERSE) {
        if (rem == 1) chunk_round<K, 1, true>(s, top, log_c, log_n, c, w, ws, q, two_q);
        if (rem == 2) chunk_round<K, 2, true>(s, top, log_c, log_n, c, w, ws, q, two_q);
    }
}

// Grid: one cluster of P blocks per row, limb-major (cluster id = l * B + b).
// Forward and inverse: x below 4q, y exact.  x may equal y: every block has
// read what it needs of x before the cluster barrier after which any block
// writes y.  Two blocks an SM caps a thread at 64 registers: uncapped, the
// inverse at K = 3 took 76 and ran one block an SM, at half the speed.
template <int K, bool INVERSE>
__global__ void __launch_bounds__(MAX_THREADS, 2) ntt_cluster(const Args a) {
    constexpr int P = 1 << K;
    extern __shared__ u64 s[];
    const int c = (int)cluster_rank();
    const int log_n = a.log_n, log_c = log_n - K;
    const int C = 1 << log_c, cols = C >> K;
    const int cluster_id = blockIdx.x >> K;
    const int l = cluster_id / a.batch, b = cluster_id - l * a.batch;
    const size_t n = (size_t)1 << log_n;
    const size_t row = (size_t)b * a.L + l;
    const int limb = __ldg(a.limbs + l);
    const u64* __restrict__ consts = a.consts;
    const u64 q = __ldg(consts + 4 * limb), two_q = 2 * q;
    const u64* __restrict__ w = a.tw + (size_t)limb * n;
    const u64* __restrict__ ws = a.tws + (size_t)limb * n;
    const u64* src = a.x + row * n;
    u64* dst = a.y + row * n;
    // column r's value j lives in block j's shared memory at word swz(r)
    const uint32_t s_base = (uint32_t)__cvta_generic_to_shared(s);
    // columns per thread: cols is a multiple of blockDim.x (launch plan)
    const int per = cols / (int)blockDim.x;

    if (!INVERSE) {
        cluster_arrive_relaxed();
        for (int it = 0; it < per; ++it) {
            const int r = c * cols + it * blockDim.x + threadIdx.x;
            u64 v[P];
#pragma unroll
            for (int j = 0; j < P; ++j) v[j] = src[r + ((size_t)j << log_c)];
            // stage m = 2^st: m groups, local stride tl (in chunks), twiddle w[m + j]
#pragma unroll
            for (int st = 0; st < K; ++st) {
                const int m = 1 << st, tl = P >> (st + 1);
#pragma unroll
                for (int j = 0; j < m; ++j) {
                    const u64 W = __ldg(w + m + j), WS = __ldg(ws + m + j);
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
            // the other blocks of the cluster have started before any store
            // reaches their shared memory
            if (it == 0) cluster_wait();
            const uint32_t at = s_base + 8u * swz(r);
#pragma unroll
            for (int j = 0; j < P; ++j) st_cluster(map_rank(at, j), v[j]);
        }
        cluster_arrive();
        cluster_wait();

        chunk_stages<K, false>(s, log_c, log_n, c, w, ws, q, two_q);
        const u64 u0 = __ldg(consts + 4 * limb + 1);
        u64* out = dst + ((size_t)c << log_c);
        for (int i = threadIdx.x; i < C; i += blockDim.x) out[i] = bred_add(s[swz(i)], q, u0);
    } else {
        const u64* in = src + ((size_t)c << log_c);
        for (int i = threadIdx.x; i < C; i += blockDim.x)
            s[swz(i)] = fold2q(fold2q(in[i], two_q), two_q);
        __syncthreads();
        chunk_stages<K, true>(s, log_c, log_n, c, w, ws, q, two_q);
        cluster_arrive();
        cluster_wait();

        const u64 ninv = __ldg(consts + 4 * limb + 2), ninvs = __ldg(consts + 4 * limb + 3);
        for (int it = 0; it < per; ++it) {
            const int r = c * cols + it * blockDim.x + threadIdx.x;
            const uint32_t at = s_base + 8u * swz(r);
            u64 v[P];
#pragma unroll
            for (int j = 0; j < P; ++j) v[j] = ld_cluster(map_rank(at, j));
            // stage h = 2^st, h = P/2 .. 1: local stride tl = P / (2h)
#pragma unroll
            for (int st = K - 1; st >= 0; --st) {
                const int h = 1 << st, tl = P >> (st + 1);
#pragma unroll
                for (int j = 0; j < h; ++j) {
                    const u64 W = __ldg(w + h + j), WS = __ldg(ws + h + j);
#pragma unroll
                    for (int k = 0; k < tl; ++k) {
                        const int iu = 2 * j * tl + k, iv = iu + tl;
                        const u64 U = v[iu], V = v[iv];
                        v[iu] = fold2q(U + V, two_q);
                        v[iv] = mul_shoup(U + two_q - V, W, WS, q);
                    }
                }
            }
#pragma unroll
            for (int j = 0; j < P; ++j)
                dst[r + ((size_t)j << log_c)] = cred(mul_shoup(v[j], ninv, ninvs, q), q);
        }
        // no block leaves while another may still read its shared memory
        cluster_arrive();
        cluster_wait();
    }
}

constexpr int MAX_DEVICES = 64;
// Per device and instantiation: the dynamic shared memory has been granted.
static bool g_granted[MAX_DEVICES][MAX_K + 1][2];
// Per device, direction and log N: at least one cluster of the plan's shape
// fits the device (checked once with cudaOccupancyMaxActiveClusters).
static bool g_fits[MAX_DEVICES][2][MAX_LOG_N + 1];

template <int K, bool INVERSE>
static int launch(const Args& a, int rows, int threads, int smem, cudaStream_t stream) {
    const auto kernel = ntt_cluster<K, INVERSE>;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1 << K;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)((size_t)rows << K));
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;

    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess && dev >= MAX_DEVICES) err = cudaErrorInvalidDevice;
    if (err == cudaSuccess && !g_granted[dev][K][INVERSE]) {
        // above 48 KB dynamic shared memory has to be granted explicitly: the
        // most a block may opt into, for every log N of this instantiation
        int most = 0;
        err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
        g_granted[dev][K][INVERSE] = err == cudaSuccess;
    }
    if (err == cudaSuccess && !g_fits[dev][INVERSE][a.log_n]) {
        int clusters = 0;
        err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
        if (err == cudaSuccess && clusters < 1) return -1;
        g_fits[dev][INVERSE][a.log_n] = err == cudaSuccess;
    }
    if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kernel, a);
    if (err == cudaSuccess) err = cudaGetLastError();
    else cudaGetLastError();  // clear a launch error, the caller raises
    return (int)err;
}

// x, out: [rows = B*L, n] uint64 (row b*L + l carries limb table limbs[l]).
// The launch plan comes from the caller: k column stages (a cluster of 2^k
// blocks), `threads` a block, `smem` = 8 n / 2^k bytes of shared memory.
// Returns 0 when the one kernel launched, a CUDA error code when a call
// failed, -1 when no cluster of this shape fits the device, -2 when the
// plan is not one the kernel takes.  Nothing falls back.
extern "C" int ntt_passes_launch(const void* x, void* out, const void* tw, const void* tws,
                                 const void* consts, const void* limbs, int rows, int L,
                                 int log_n, int k, int threads, int smem, int inverse,
                                 void* stream) {
    if (log_n < MIN_LOG_N || log_n > MAX_LOG_N || k < 1 || k > MAX_K || L < 1 || rows < L ||
        rows % L != 0 || ((size_t)rows << k) > 0x7fffffff)
        return -2;
    const int chunk = 1 << (log_n - k), cols = chunk >> k;
    if (smem != chunk * (int)sizeof(u64) || threads < 32 || threads > MAX_THREADS ||
        threads > chunk / 2 || cols % threads != 0)
        return -2;
    const Args a{(const u64*)x, (u64*)out, (const u64*)tw, (const u64*)tws,
                 (const u64*)consts, (const int*)limbs, rows / L, L, log_n};
    const cudaStream_t st = (cudaStream_t)stream;
    switch (k * 2 + (inverse != 0)) {
        case 2: return launch<1, false>(a, rows, threads, smem, st);
        case 3: return launch<1, true>(a, rows, threads, smem, st);
        case 4: return launch<2, false>(a, rows, threads, smem, st);
        case 5: return launch<2, true>(a, rows, threads, smem, st);
        case 6: return launch<3, false>(a, rows, threads, smem, st);
        default: return launch<3, true>(a, rows, threads, smem, st);
    }
}
