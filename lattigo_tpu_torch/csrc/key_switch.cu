// The key switch's inner product: one launch computes both key halves over
// every decomposition block,
//
//   out[h, b, l, n] = bred_add(fold_i mred(key_h[i, ql[l], n], d[b, i, l, idx(n)]))
//
// with q, qinv, u0 the ring table row ql[l] of output limb l; the key
// keeps every limb of the ring in its order, so ql[l] is its row too.
// fold_i is the plain version's schedule exactly (ops/key_switch.py
// inner_product_plain): the first product, then each next one added
// (wrapping mod 2^64), a bred_add whenever 7 products are pending, and one
// bred_add at the end.
// So the kernel equals the plain version bit for bit on any 64-bit words.
//
// No TPU kernel: under jax.jit XLA fuses this fold of the JAX package
// (lattigo_tpu/models/ckks/evaluator.py _inner_product, and the loop in
// lattigo_tpu/models/bfv/evaluator.py _switch_keys_core) into one device
// pass.  The port ran it as one modred.cu launch per key half (each
// reading d, each writing a whole [.., beta, L, N] product), the adds of
// PyTorch and the reductions, after a torch.cat of the key planes.
//
// Operands: d as a pointer and its (batch, block, limb, coefficient)
// strides (the BFV layout [beta, B, L, N] and the CKKS layout
// [B, beta, L, N] differ); both key halves [beta_k, L_k, N] with one set of
// strides; the ring's q, qinv and u0 tables by row; the per-limb map ql
// (table and key row); an optional NTT-domain permutation idx of the
// coefficients (galois.permute_ntt's index), read instead of a permuted
// copy of d.  The output is [2, B, L, N], contiguous.
//
// Bound on the H100: the bytes (d read once, both key halves and the map
// once, both outputs written once, at 3.35 TB/s); a d word meets two
// Montgomery products of 14 int32 multiplies, 8 bytes per 28 multiplies,
// about half the time of the bytes at the multiply rate.  What the design
// does about it: a thread owns one (limb, coefficient) and a tile of up to
// MAX_TILE batch entries; it loads each key word once for the tile and each
// d word once for both halves, and keeps the 2 x TILE running sums in
// registers, so no product and no partial sum goes through memory; it
// loads block i + 1 before it folds block i, so that its loads stay in
// flight while it multiplies.  Neighbouring threads take neighbouring
// coefficients (a warp reads 256 contiguous bytes of d, or gathers them
// through idx); a block's limb, and with it the per-limb constants and map
// entry, is uniform across its warps.  The tile is the smallest power of
// two that holds the batch, so a single ciphertext costs no registers for
// running sums it does not have.
#include <cstdint>
#include "modarith.cuh"

constexpr int MAX_TILE = 8;  // batch entries a thread walks with one key word
constexpr int PENDING = 7;   // products summed before a reduction
constexpr int THREADS = 256;
constexpr long long MAX_GRID_Z = 65535;

struct Args {
    const u64* d;  // d[b, i, l, n] at b * sdb + i * sdi + l * sdl + n * sdn
    long long sdb, sdi, sdl, sdn;
    const u64* key[2];  // key_h[i, r, n] at i * ski + r * skl + n * skn
    long long ski, skl, skn;
    const u64* q;  // ring tables, one word a row
    const u64* qinv;
    const u64* u0;
    const int* ql;  // output limb -> ring table row and key row
    const long long* idx;  // coefficient n reads d at idx[n]; null: at n
    u64* out;  // [2, B, L, N], contiguous
    long long B, N;
    int L, beta;
};

// Batch entries a thread takes: the smallest power of two that holds the
// batch, at most MAX_TILE (registers hold 2 x tile running sums).
inline int tile_of(long long B) {
    int t = 1;
    while (t < MAX_TILE && t < B) t *= 2;
    return t;
}

// The words of block i: both key halves' and those of d for the tile's
// batch entries below nb.
template <int TILE>
__device__ __forceinline__ void load_block(const Args& a, const u64* dl, long long koff, int i,
                                           int nb, u64 (&k)[2], u64 (&x)[TILE]) {
    k[0] = a.key[0][i * a.ski + koff];
    k[1] = a.key[1][i * a.ski + koff];
#pragma unroll
    for (int t = 0; t < TILE; ++t)
        if (t < nb) x[t] = dl[t * a.sdb + i * a.sdi];
}

// The words loaded ahead (kn, xn) become those folded next (k, x).
template <int TILE>
__device__ __forceinline__ void take_block(int nb, u64 (&k)[2], u64 (&x)[TILE],
                                           const u64 (&kn)[2], const u64 (&xn)[TILE]) {
    k[0] = kn[0];
    k[1] = kn[1];
#pragma unroll
    for (int t = 0; t < TILE; ++t)
        if (t < nb) x[t] = xn[t];
}

// Both halves of output limb l at coefficient n for batch entries
// b0 .. b0 + TILE - 1 (those below B).
template <int TILE>
__device__ __forceinline__ void key_switch_tile(const Args& a, long long b0, int l, long long n) {
    const int nb = a.B - b0 < TILE ? (int)(a.B - b0) : TILE;
    const int r = a.ql[l];
    const u64 q = a.q[r], qinv = a.qinv[r], u0 = a.u0[r];
    const long long koff = (long long)r * a.skl + n * a.skn;
    const long long col = (a.idx ? a.idx[n] : n) * a.sdn;
    const u64* dl = a.d + b0 * a.sdb + l * a.sdl + col;
    u64 acc[2][TILE];
    u64 k[2], x[TILE];
    load_block<TILE>(a, dl, koff, 0, nb, k, x);
    int pending = 0;
    for (int i = 0; i < a.beta; ++i) {
        u64 kn[2], xn[TILE];
        if (i + 1 < a.beta) load_block<TILE>(a, dl, koff, i + 1, nb, kn, xn);  // ahead
#pragma unroll
        for (int t = 0; t < TILE; ++t) {
            if (t < nb) {
                const u64 p0 = mred(k[0], x[t], q, qinv);
                const u64 p1 = mred(k[1], x[t], q, qinv);
                acc[0][t] = i == 0 ? p0 : acc[0][t] + p0;
                acc[1][t] = i == 0 ? p1 : acc[1][t] + p1;
            }
        }
        pending = i == 0 ? 1 : pending + 1;
        if (pending == PENDING) {
#pragma unroll
            for (int t = 0; t < TILE; ++t)
                if (t < nb) {
                    acc[0][t] = bred_add(acc[0][t], q, u0);
                    acc[1][t] = bred_add(acc[1][t], q, u0);
                }
            pending = 1;
        }
        if (i + 1 < a.beta) take_block<TILE>(nb, k, x, kn, xn);
    }
    const long long half = a.B * a.L * a.N;
#pragma unroll
    for (int t = 0; t < TILE; ++t) {
        if (t < nb) {
            u64* o = a.out + ((b0 + t) * a.L + l) * a.N + n;
            o[0] = bred_add(acc[0][t], q, u0);
            o[half] = bred_add(acc[1][t], q, u0);
        }
    }
}

// The C entries' arguments, checked: 0, or -2 for what the kernel does not
// take.  dstr: d's strides (b, i, l, n); kstr: the keys' (i, r, n).
inline int make_args(Args& a, const void* d, const long long* dstr, const void* key0,
                     const void* key1, const long long* kstr, const void* q, const void* qinv,
                     const void* u0, const void* ql, const void* idx, void* out, long long B,
                     long long N, int L, int beta) {
    if (!d || !dstr || !key0 || !key1 || !kstr || !q || !qinv || !u0 || !ql || !out || B < 1 ||
        N < 1 || L < 1 || L > 65535 || beta < 1)
        return -2;
    a = Args{(const u64*)d, dstr[0], dstr[1], dstr[2], dstr[3],
             {(const u64*)key0, (const u64*)key1}, kstr[0], kstr[1], kstr[2],
             (const u64*)q, (const u64*)qinv, (const u64*)u0, (const int*)ql,
             (const long long*)idx, (u64*)out, B, N, L, beta};
    return 0;
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

// blockIdx.x: a chunk of coefficients; blockIdx.y: the output limb;
// blockIdx.z: tiles of TILE batch entries, strided by gridDim.z
template <int TILE>
__global__ void __launch_bounds__(THREADS) key_switch_kernel(const Args a) {
    const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= a.N) return;
    for (long long b0 = (long long)blockIdx.z * TILE; b0 < a.B; b0 += (long long)gridDim.z * TILE)
        key_switch_tile<TILE>(a, b0, (int)blockIdx.y, n);
}

template <int TILE>
static void launch(const Args& a, cudaStream_t stream) {
    const int threads = a.N >= THREADS ? THREADS : (int)((a.N + 31) / 32 * 32);
    const long long tiles = (a.B + TILE - 1) / TILE;
    const dim3 grid((unsigned)((a.N + threads - 1) / threads), (unsigned)a.L,
                    (unsigned)(tiles < MAX_GRID_Z ? tiles : MAX_GRID_Z));
    key_switch_kernel<TILE><<<grid, threads, 0, stream>>>(a);
}

// Returns -2 for an argument the kernel does not take, else the CUDA error
// of the launch.
extern "C" int key_switch_launch(const void* d, const long long* dstr, const void* key0,
                                 const void* key1, const long long* kstr, const void* q,
                                 const void* qinv, const void* u0, const void* ql,
                                 const void* idx, void* out, long long B, long long N, int L,
                                 int beta, void* stream) {
    Args a;
    if (make_args(a, d, dstr, key0, key1, kstr, q, qinv, u0, ql, idx, out, B, N, L, beta))
        return -2;
    switch (tile_of(B)) {
        case 1: launch<1>(a, (cudaStream_t)stream); break;
        case 2: launch<2>(a, (cudaStream_t)stream); break;
        case 4: launch<4>(a, (cudaStream_t)stream); break;
        default: launch<MAX_TILE>(a, (cudaStream_t)stream);
    }
    return (int)cudaGetLastError();
}
#endif  // __CUDACC__
