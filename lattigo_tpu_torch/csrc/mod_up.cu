// The fast basis extension (HPS'18 base conversion) of ops/basis_ext.py:
// a tensor [B, ls, N] of residues in the source basis to [B, k, N] in k
// selected destination limbs, one launch; and the key switch's
// decomposition (basis_ext.Decomposer.decompose), every digit of a
// [B, L, N] tensor into its slice of one stacked [B, beta, L + K, N]
// tensor, one launch.
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
// The decomposition (mod_up_kernel_digits) computes Decomposer.decompose_plain
// bit for bit: digit j's ls source limbs start .. start + ls - 1 pass through
// to the same rows of its slice, the conversion fills the other L - ls Q rows
// and the K P rows; a digit of one source limb is that raw residue in all
// L + K rows.  The grid's y is the digit, so a block copies only its digit's
// tables, and c2 is read once, d written once, with no copy between.
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
// rows, [ls, ld]), sel the k destination limbs to produce (null: all ld, in
// order), ys scratch for the y_i at ys[i * sy], output kk at out[r * so]
// where r = kk, or kk + gap from kk = gap_at on (the rows a digit's own
// limbs take).
__device__ __forceinline__ void mod_up_column(const u64* x, long long sx, const u64* tab,
                                              const int* sel, u64* ys, int sy, u64* out,
                                              long long so, int ls, int ld, int k,
                                              int centered, int gap_at = 0, int gap = 0) {
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
        const int j = sel ? sel[kk] : kk;
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
        out[(kk < gap_at ? kk : kk + gap) * so] = o;
    }
}

// The decomposition's digit table (basis_ext.Decomposer.digit_table): for
// each digit j, DIGIT_WORDS words at tab[DIGIT_WORDS * j]: its first source
// limb, its source limb count ls and the address of its packed ModUpParams
// (the tables its mod_up would read, not copied).
constexpr int DIGIT_WORDS = 3;

// Digit j of one coefficient column: x the column's L residues at x[l * sx],
// tab digit j's packed tables (unused for ls = 1), out its slice's L + K rows
// at out[r * so].
__device__ __forceinline__ void digit_column(const u64* x, long long sx, const u64* tab,
                                             u64* ys, int sy, u64* out, long long so,
                                             int start, int ls, int L, int K) {
    if (ls == 1) {  // one source limb: its raw residue in every row
        const u64 v = x[start * sx];
        for (int r = 0; r < L + K; ++r) out[r * so] = v;
        return;
    }
    for (int i = 0; i < ls; ++i) out[(start + i) * so] = x[(start + i) * sx];
    const int ld = L - ls + K;
    mod_up_column(x + start * sx, sx, tab, nullptr, ys, sy, out, so, ls, ld, ld, 0, start, ls);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

constexpr int MAX_THREADS = 128;
constexpr int DEFAULT_SMEM = 48 * 1024;
constexpr int MAX_SMEM = 227 * 1024;
constexpr int MAX_DEVICES = 64;
static bool g_granted[MAX_DEVICES], g_granted_digits[MAX_DEVICES];

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

// The threads a block (at most MAX_THREADS, at least 32) whose tables
// (words) and y_i (ls a thread) fit the default shared memory, and their
// bytes; 0 threads where not even 32 fit the most the card gives.
static int block_of(int words, int ls, size_t* smem) {
    int threads = MAX_THREADS;
    while (threads > 32 && (size_t)(words + ls * threads) * sizeof(u64) > DEFAULT_SMEM)
        threads /= 2;
    *smem = (size_t)(words + ls * threads) * sizeof(u64);
    return *smem > MAX_SMEM ? 0 : threads;
}

// Above 48 KB dynamic shared memory has to be granted explicitly: the most
// the card gives, once per device and kernel.  Returns the CUDA error.
static cudaError_t grant(const void* kernel, bool* granted, size_t smem) {
    if (smem <= DEFAULT_SMEM) return cudaSuccess;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess && dev >= MAX_DEVICES) err = cudaErrorInvalidDevice;
    if (err == cudaSuccess && !granted[dev]) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
        granted[dev] = err == cudaSuccess;
    }
    if (err != cudaSuccess) cudaGetLastError();  // clear the error, the caller raises
    return err;
}

// Returns -2 for an argument the kernel does not take, else the CUDA error
// of the launch.
extern "C" int mod_up_launch(const void* x, long long sb, long long sl, long long sn,
                             const void* tab, const void* sel, void* out, long long B,
                             long long N, int ls, int ld, int k, int centered, void* stream) {
    if (!x || !tab || !sel || !out || B < 1 || N < 1 || ls < 1 || ld < 1 || k < 1)
        return -2;
    size_t smem;
    const int threads = block_of(5 * ls + 5 * ld + ls * ld, ls, &smem);
    if (!threads) return -2;
    const cudaError_t err = grant((const void*)mod_up_kernel, g_granted, smem);
    if (err != cudaSuccess) return (int)err;
    const Args a{(const u64*)x, sb, sl, sn, (const u64*)tab, (const int*)sel, (u64*)out,
                 B, N, ls, ld, k, centered};
    const long long cols = B * N;
    mod_up_kernel<<<(unsigned)((cols + threads - 1) / threads), threads, smem,
                    (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

struct DigitArgs {
    const u64* x;            // [B, L, N] with strides sb, sl, sn
    long long sb, sl, sn;
    const u64* tab;          // the digit table (DIGIT_WORDS)
    u64* out;                // [B, beta, L + K, N], contiguous
    long long B, N;
    int L, K, beta;
};

// one thread a column (b, n) of digit blockIdx.y; the digit's tables and
// the columns' y_i in shared memory
__global__ void __launch_bounds__(MAX_THREADS) mod_up_kernel_digits(const DigitArgs a) {
    extern __shared__ u64 sm[];
    const int j = blockIdx.y;
    const u64* head = a.tab + DIGIT_WORDS * j;
    const int start = (int)head[0], ls = (int)head[1];
    const int words = ls == 1 ? 0 : 5 * ls + 5 * (a.L - ls + a.K) + ls * (a.L - ls + a.K);
    const u64* tab = (const u64*)head[2];
    for (int i = threadIdx.x; i < words; i += blockDim.x) sm[i] = tab[i];
    __syncthreads();
    const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (col >= a.B * a.N) return;
    const long long b = col / a.N, n = col - b * a.N;
    digit_column(a.x + b * a.sb + n * a.sn, a.sl, sm, sm + words + threadIdx.x, blockDim.x,
                 a.out + ((b * a.beta + j) * (a.L + a.K)) * a.N + n, a.N, start, ls, a.L, a.K);
}

// The decomposition of x ([B, L, N], strides sb, sl, sn) into out
// ([B, beta, L + K, N]); tab the digit table, words the most table words and
// max_ls the most source limbs of a digit.  Returns -2 for an argument the
// kernel does not take, else the CUDA error of the launch.
extern "C" int decompose_launch(const void* x, long long sb, long long sl, long long sn,
                                const void* tab, void* out, long long B, long long N, int L,
                                int K, int beta, int words, int max_ls, void* stream) {
    if (!x || !tab || !out || B < 1 || N < 1 || L < 1 || K < 1 || beta < 1 || beta > 65535 ||
        words < 0 || max_ls < 1)
        return -2;
    size_t smem;
    const int threads = block_of(words, max_ls, &smem);
    if (!threads) return -2;
    const cudaError_t err = grant((const void*)mod_up_kernel_digits, g_granted_digits, smem);
    if (err != cudaSuccess) return (int)err;
    const DigitArgs a{(const u64*)x, sb, sl, sn, (const u64*)tab, (u64*)out, B, N, L, K, beta};
    const long long cols = B * N;
    const dim3 grid((unsigned)((cols + threads - 1) / threads), (unsigned)beta);
    mod_up_kernel_digits<<<grid, threads, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
#endif  // __CUDACC__
