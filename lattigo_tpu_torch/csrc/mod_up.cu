// The fast basis extension (HPS'18 base conversion) of ops/basis_ext.py:
// a tensor [B, ls, N] of residues in the source basis to [B, k, N] in k
// selected destination limbs, one launch.
//
// No TPU kernel: under jax.jit, XLA fuses lattigo_tpu/ops/basis_ext.py's
// mod_up (:74) into one device pass.  The port ran it as plain PyTorch ops,
// about 290 elementwise passes for one call at PN12QP109; this kernel is the
// one pass.  It computes mod_up_plain (ops/basis_ext.py) bit for bit:
//   y_i  = mred(x_i, (Q/q_i)^-1)                               (mod q_i)
//   vacc = sum_i mulhi(y_i, m_lo_i) + y_i m_hi_i  + 2 ls + 1    (58-bit fixed point)
//   v    = vacc >> 58
//   out_j = bred_add(sum_i mred(y_i, Q/q_i mod p_j) + mred(v, -Q mod p_j))
// with the sum reduced every 7 terms (bred_add) as the plain version does,
// and for centered=1 the lift of x - Q where bit 57 of vacc is set:
// out_j = cred(out_j + (-Q mod p_j)).
//
// One thread a coefficient column (b, n): it reads the ls source residues
// (neighbouring threads on neighbouring n), keeps its y_i in shared memory
// ([ls][threads], a thread's words a bank apart), and writes its k outputs.
// The tables ops/basis_ext.ModUpParams packs (5 ls + 5 ld + ls ld words:
// at most about 12 KB at ls = 34, ld = 38) are copied into shared memory by
// every block.
//
// Bound on the H100: the larger of the bytes (8 (ls + k) a column at
// 3.35 TB/s) and the operations ((ls (k + 1) + k) Montgomery products of 14
// int32 multiplies and ls fixed-point terms of 7, at 16.75 T multiplies/s):
// from ls = 2 on the operations bound it.  What the design does about it:
// every product is __umul64hi and one low multiply, each y_i is computed
// once a column, and each table word is read from shared memory.
#include <cstdint>
#include "modarith.cuh"

constexpr int V_FRAC_BITS = 58;

// One coefficient column: x[i * sx] the ls source residues, tab the packed
// tables (ModUpParams.packed: [5, ls] source rows, [5, ld] destination
// rows, [ls, ld]), sel the k destination limbs to produce, ys scratch for
// the y_i at ys[i * sy], the outputs at out[kk * so].
__device__ __forceinline__ void mod_up_column(const u64* x, long long sx, const u64* tab,
                                              const int* sel, u64* ys, int sy, u64* out,
                                              long long so, int ls, int ld, int k,
                                              int centered) {
    const u64 *qib = tab, *m_lo = tab + ls, *m_hi = tab + 2 * ls, *sq = tab + 3 * ls,
              *sqinv = tab + 4 * ls;
    const u64 *dp = tab + 5 * ls, *dpinv = dp + ld, *dp_u0 = dp + 2 * ld, *negq = dp + 3 * ld,
              *negq_plain = dp + 4 * ld;
    const u64* qispj = dp + 5 * ld;
    u64 vacc = 0;
    for (int i = 0; i < ls; ++i) {
        const u64 y = mred(x[i * sx], qib[i], sq[i], sqinv[i]);
        ys[i * sy] = y;
        vacc += __umul64hi(y, m_lo[i]) + y * m_hi[i];
    }
    vacc += 2 * ls + 1;
    const u64 v = vacc >> V_FRAC_BITS;
    const bool upper = centered && ((vacc >> (V_FRAC_BITS - 1)) & 1);
    for (int kk = 0; kk < k; ++kk) {
        const int j = sel[kk];
        const u64 p = dp[j], pinv = dpinv[j], u0 = dp_u0[j];
        u64 acc = mred(ys[0], qispj[j], p, pinv);
        int pending = 1;
        for (int i = 1; i < ls; ++i) {
            acc += mred(ys[i * sy], qispj[i * ld + j], p, pinv);
            if (++pending == 7) {
                acc = bred_add(acc, p, u0);
                pending = 1;
            }
        }
        u64 o = bred_add(acc + mred(v, negq[j], p, pinv), p, u0);
        if (upper) o = cred(o + negq_plain[j], p);
        out[kk * so] = o;
    }
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

constexpr int MAX_THREADS = 128;
constexpr int DEFAULT_SMEM = 48 * 1024;
constexpr int MAX_SMEM = 227 * 1024;
constexpr int MAX_DEVICES = 64;
static bool g_granted[MAX_DEVICES];

struct Args {
    const u64* x;            // [B, ls, N] with strides sb, sl, sn
    long long sb, sl, sn;
    const u64* tab;          // ModUpParams.packed
    const int* sel;          // [k] destination limbs to produce
    u64* out;                // [B, k, N], contiguous
    long long B, N;
    int ls, ld, k, centered;
};

// one thread a column (b, n); the tables and the columns' y_i in shared
// memory
__global__ void __launch_bounds__(MAX_THREADS) mod_up_kernel(const Args a) {
    extern __shared__ u64 sm[];
    const int words = 5 * a.ls + 5 * a.ld + a.ls * a.ld;
    for (int i = threadIdx.x; i < words; i += blockDim.x) sm[i] = a.tab[i];
    __syncthreads();
    const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (col >= a.B * a.N) return;
    const long long b = col / a.N, n = col - b * a.N;
    mod_up_column(a.x + b * a.sb + n * a.sn, a.sl, sm, a.sel, sm + words + threadIdx.x,
                  blockDim.x, a.out + b * a.k * a.N + n, a.N, a.ls, a.ld, a.k, a.centered);
}

// Returns -2 for an argument the kernel does not take, else the CUDA error
// of the launch.
extern "C" int mod_up_launch(const void* x, long long sb, long long sl, long long sn,
                             const void* tab, const void* sel, void* out, long long B,
                             long long N, int ls, int ld, int k, int centered, void* stream) {
    if (!x || !tab || !sel || !out || B < 1 || N < 1 || ls < 1 || ld < 1 || k < 1)
        return -2;
    const int words = 5 * ls + 5 * ld + ls * ld;
    int threads = MAX_THREADS;
    while (threads > 32 && (size_t)(words + ls * threads) * sizeof(u64) > DEFAULT_SMEM)
        threads /= 2;
    const size_t smem = (size_t)(words + ls * threads) * sizeof(u64);
    if (smem > MAX_SMEM) return -2;
    cudaError_t err = cudaSuccess;
    if (smem > DEFAULT_SMEM) {
        // above 48 KB dynamic shared memory has to be granted explicitly:
        // the most the card gives, once per device
        int dev = 0;
        err = cudaGetDevice(&dev);
        if (err == cudaSuccess && dev >= MAX_DEVICES) err = cudaErrorInvalidDevice;
        if (err == cudaSuccess && !g_granted[dev]) {
            err = cudaFuncSetAttribute(mod_up_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       MAX_SMEM);
            g_granted[dev] = err == cudaSuccess;
        }
    }
    if (err != cudaSuccess) {
        cudaGetLastError();  // clear the error, the caller raises
        return (int)err;
    }
    const Args a{(const u64*)x, sb, sl, sn, (const u64*)tab, (const int*)sel, (u64*)out,
                 B, N, ls, ld, k, centered};
    const long long cols = B * N;
    mod_up_kernel<<<(unsigned)((cols + threads - 1) / threads), threads, smem,
                    (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
#endif  // __CUDACC__
