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
// The products are exact int8 tensor-core products of byte digits
// (mma.sync m16n8k32, u8 x s8 -> s32).  An x word below q_l is its dx_l =
// ceil(bits(q_l) / 8) bytes (u8); a weight is its centered residue (in
// (-q/2, q/2): the signed integer round(w Delta) itself wherever that is
// below q/2) as DW balanced digits (s8), DW the fewest that hold every
// weight of the layer (5, 4 and 5 at the CryptoNets cell's layers; up to
// 8 for any residue below 2^61).  The product of byte d and digit a goes
// into the s32 plane e = a + d, so sum_e P_e 2^(8e) is the exact sum of
// the products: DW * dx byte products a product, the yardstick's count
// (fhe_bench/ct_matrix_roofline.py).  The 8 x 8 Toeplitz layout of
// ntt_fourstep.cu, which contracts over the bytes of a word and needs no
// byte split, would form (DW + dx - 1) * 8 byte products instead: about 4x
// as many at the 845 -> 100 layer.
//
// Plane fold: a tap adds at most 128 * 255 * min(DW, dx) to a plane in
// size, so every `fold` k-steps of 32 taps (the caller's bound: fold * 32
// * 128 * 255 * min(DW, dx) below 2^62 / 0x0101010101, about 2^30; 128
// k-steps or more) each output's planes are recombined into its residue
// mod q, whose bytes become the planes the next products add to.
// Recombining: planes 5k .. 5k + 4 make an int64, offset to be nonnegative
// and reduced times 2^(40k) mod q (a Shoup product); the offsets come off
// as one constant.  Every output
// word is the canonical residue in [0, q), so any exact schedule (the
// plain version in ops/ct_matrix.py, Python integers) gives the same
// words.
//
// Layout: the rows of one m16n8 product are 8 coefficients of both
// polynomials (row g: x_0 at coefficient g; row g + 8: x_1 at g), its
// columns the up to 8 outputs of one tile (outputs that read the same
// inputs: a dense layer's outputs, the maps of a convolution at one
// position), its contraction 32 taps.  Tiles with the same inputs form a
// group, cut into slabs of up to tb tiles.  A block of ceil(tb / TPW) x ss
// warps takes a run of slabs, one limb and 8 ss coefficients; each warp
// computes TPW tiles (two where a group has two or more and their
// accumulators fit: 5 digits, 6 bytes) of each slab on 8 coefficients of
// its own.  Each lane gathers its 16 x words of a step (8 taps, both
// polynomials, its coefficient) into registers and splits them into byte
// planes there (__byte_perm), once for its warp's tiles: no shared memory
// and no barrier, so L1 keeps the words that the warps of a slab (a dense
// layer's tiles) and neighbouring slabs (a convolution's next position)
// read again.  The weights' digits are stored in B fragment order: one
// 8-byte word a lane, k-step and digit.  An output's epilogue reads its
// row and bias before recombining.
//
// Bound on the H100 (fhe_bench/ct_matrix_roofline.py): the bytes, at every
// layer of the CryptoNets cell (x read once, the outputs written once);
// the byte products take less at the int8 peak.  The design's answer to
// the operations is the tensor cores; to the bytes, that x reaches device
// memory about once, the rest of its reads being L1 and L2 hits.  What
// holds it above the bound is the work around the products, at a low
// instruction throughput: the gather, the byte split and each output's
// recombination (chip_smoke.py's ct_matrix phase: about 5 x and 7 x the
// bound at the convolution and the 845 -> 100 layer).
//
// Operands: x_0 and x_1, the stack's two polynomials [K, L, N], read with
// one set of (k, l, n) strides; col[p] the input of tap p; tiles[t] =
// (first tap p0, taps, outputs, first k-step, the outputs' indices; the
// columns of a tile run to a whole number of steps, one at least);
// slabs[s] = (first tap, taps, first tile, tiles); wd the digits [L, WK,
// DW, 32 lanes, 8 bytes] (WK the tiles' k-steps); the bias b[j, l] (null:
// none); consts[l] as recombine() says; out [2, J, L, N], contiguous.
#include <cstdint>
#include "modarith.cuh"

constexpr int MAX_TILE = 8;          // outputs of a tile: the n8 of the product
constexpr int TABLE = 4 + MAX_TILE;  // words of a tile's row in tiles
constexpr int SLAB = 4;              // words of a slab's row in slabs
constexpr int CONSTS = 10;           // words a limb in consts
constexpr int KSTEP = 32;            // taps of one product (k32), and of a step
constexpr int MAX_WARPS = 8;

#ifndef __CUDACC__
// __byte_perm(x, y, s): byte i of the result is byte (s >> 4i) & 7 of y:x.
static inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
    const u64 v = (u64)y << 32 | x;
    unsigned r = 0;
    for (int i = 0; i < 4; ++i) r |= (unsigned)(v >> (8 * ((s >> (4 * i)) & 7)) & 0xff) << (8 * i);
    return r;
}
#define __ldg(p) (*(p))
#endif

struct Args {
    const u64* x0;  // x_h[k, l, n] at k * sk + l * sl + n * sn
    const u64* x1;
    long long sk, sl, sn;
    const u64* wd;  // lane's B fragment of (limb, k-step, digit) at ((l * WK + ks) * dw + a) * 32
    const int* col;  // col[p]: the input of tap p
    const long long* tiles;  // [T, TABLE]
    const long long* slabs;  // [S, SLAB]
    const u64* bias;  // b[j, l] at j * L + l; null: none
    const u64* consts;  // [L, CONSTS]
    u64* out;  // [2, J, L, N], contiguous
    long long S, WK, J, N;
    int L, dw, tb, tpw, ss, run, fold;  // tb tiles a slab, tpw of them a warp
};

struct Frag {
    unsigned r[4];
};

// b[d] = byte d of each of w0..w3 (byte j of b[d] from w_j), d < 4.
__device__ __forceinline__ void transpose4(unsigned w0, unsigned w1, unsigned w2, unsigned w3,
                                           unsigned* b) {
    const unsigned t0 = __byte_perm(w0, w1, 0x5140), t1 = __byte_perm(w0, w1, 0x7362);
    const unsigned t2 = __byte_perm(w2, w3, 0x5140), t3 = __byte_perm(w2, w3, 0x7362);
    b[0] = __byte_perm(t0, t2, 0x5410);
    b[1] = __byte_perm(t0, t2, 0x7632);
    b[2] = __byte_perm(t1, t3, 0x5410);
    b[3] = __byte_perm(t1, t3, 0x7632);
}

// The lane's x words of step `chunk`: the lane (g, t) reads x_h at its
// coefficient (x0 / x1 at (limb, coefficient)) for taps 4t .. 4t + 3 and
// 16 + 4t .. 16 + 4t + 3 of the step, w[half][h][j] the word of tap 16 half
// + 4t + j.  The columns run to a whole step: a padding tap reads a real
// input, whose digits are zero.
__device__ __forceinline__ void load_words(const int* col, int sk, int chunk, const u64* x0,
                                           const u64* x1, int lane, u64 (&w)[2][2][4]) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int* cs = col + chunk * KSTEP + 16 * half + 4 * (lane & 3);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int at = __ldg(cs + j) * sk;
            w[half][0][j] = x0[at];
            w[half][1][j] = x1[at];
        }
    }
}

// The words as the lane's A fragments, one a byte plane d < dx: register
// 2 half + h holds byte d of the 4 words of (half, h), tap 4t + j of the
// half at byte j (rows g: x_0, g + 8: x_1 of the m16n8k32 A fragment).
template <int DXM>
__device__ __forceinline__ void split(const u64 (&w)[2][2][4], int dx, Frag (&f)[DXM]) {
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const u64* v = w[half][h];
            unsigned b[8];
            transpose4((unsigned)v[0], (unsigned)v[1], (unsigned)v[2], (unsigned)v[3], b);
            if (dx > 4)
                transpose4((unsigned)(v[0] >> 32), (unsigned)(v[1] >> 32), (unsigned)(v[2] >> 32),
                           (unsigned)(v[3] >> 32), b + 4);
#pragma unroll
            for (int d = 0; d < DXM; ++d) f[d].r[2 * half + h] = b[d];
        }
}

// The lane's B fragments of one k-step of its tile (wd at the k-step's
// digits and the lane).
template <int DW>
__device__ __forceinline__ void load_b(const u64* wd, u64 (&b)[DW]) {
#pragma unroll
    for (int a = 0; a < DW; ++a) b[a] = __ldg(wd + a * 32);
}

// One k-step: acc[a + d] += (byte plane d) x (digit a), for every pair; the
// plane of a byte product is the sum of its digits' places.  On the card
// a Frag, a u64 and an int[4] are a lane's; the host build passes a warp's.
template <int DW, int DXM, class Acc, class A, class B, class Mma>
__device__ __forceinline__ void products(Acc (&acc)[DW + DXM - 1], const A (&f)[DXM],
                                         const B (&b)[DW], int dx, const Mma& mma) {
#pragma unroll
    for (int d = 0; d < DXM; ++d)
        if (d < dx)
#pragma unroll
            for (int a = 0; a < DW; ++a) mma(acc[a + d], f[d], b[a]);
}

// A limb's constants for recombining, read once a call: consts[l] = (q,
// u0, 2^64, 2^40 and 2^80 mod q, each with its Shoup word, the offsets'
// sum's negation, dx).
struct Limb {
    u64 q, u0, r40, r40s, r80, r80s, cneg;
};

__device__ __forceinline__ Limb limb_of(const u64* c) {
    return Limb{__ldg(c), __ldg(c + 1), __ldg(c + 4), __ldg(c + 5), __ldg(c + 6), __ldg(c + 7),
                __ldg(c + 8)};
}

// sum_e P_e 2^(8e) mod q over the E planes, P_e = acc[e][i], |P_e| below
// 2^62 / 0x0101010101 (the fold's bound; a plane past DW + dx - 2 stays
// 0): planes 5k .. 5k + 4 make an int64 g_k, |g_k| < 2^62; g_k + 2^62 is
// reduced times 2^(40k) mod q (a Shoup product; k = 0 as it is), and the
// offsets' sum, 2^62 sum_k 2^(40k) mod q over the ceil(E / 5) groups,
// comes off as cneg.
template <int E>
__device__ __forceinline__ u64 recombine(const int (&acc)[E][4], int i, const Limb& m) {
    u64 sum = 0;
#pragma unroll
    for (int k = 0; 5 * k < E; ++k) {
        long long g = 1LL << 62;  // the offset
#pragma unroll
        for (int j = 0; j < 4; ++j)  // widening products by 2^(8j) < 2^31
            if (5 * k + j < E) g += (long long)acc[5 * k + j][i] * (1 << (8 * j));
        if (5 * k + 4 < E) g += (long long)acc[5 * k + 4][i] * (1LL << 32);
        const u64 v = (u64)g;
        sum += k == 0 ? v : k == 1 ? mul_shoup(v, m.r40, m.r40s, m.q)
                                  : mul_shoup(v, m.r80, m.r80s, m.q);  // < 2^63 + 4q < 2^64
    }
    return cred(bred_add(sum, m.q, m.u0) + m.cneg, m.q);
}

// Each output's planes replaced by the bytes of its residue mod q: the
// next products add to it (the fold's bound leaves room for 255 a plane).
template <int E>
__device__ __forceinline__ void fold(int (&acc)[E][4], const Limb& m) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const u64 r = recombine<E>(acc, i, m);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e][i] = e < 8 ? (int)(r >> (8 * e) & 0xff) : 0;
    }
}

// The lane's outputs (c0..c3: x_0 and x_1 at coefficient n0 + g, outputs
// 2t and 2t + 1 of the tile), the bias added to the first polynomial; the
// planes cleared for the next slab.
template <int E>
__device__ __forceinline__ void store(const Args& a, const long long* tile, int l, long long n0,
                                      int lane, int (&acc)[E][4], const Limb& m) {
    const long long n = n0 + (lane >> 2), half = a.J * a.L * a.N;
    const int outputs = (int)__ldg(tile + 2);
    long long row[2];  // the lane's two outputs' rows of out, and their biases (loaded first)
    u64 bias[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        const int o = 2 * (lane & 3) + k;
        const long long j = o < outputs ? __ldg(tile + 4 + o) : 0;
        row[k] = j * a.L + l;
        bias[k] = a.bias && o < outputs ? __ldg(a.bias + row[k]) : 0;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        if (2 * (lane & 3) + (i & 1) < outputs && n < a.N) {
            u64 v = recombine<E>(acc, i, m);
            if (i < 2) v = cred(v + bias[i], m.q);
            a.out[(i >> 1) * half + row[i & 1] * a.N + n] = v;
        }
    }
#pragma unroll
    for (int e = 0; e < E; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[e][i] = 0;
}

// Steps of a slab: one a 32 taps, one at least (the tables' columns and
// digits run to them).
__device__ __forceinline__ int steps_of(const long long* slab) {
    const int taps = (int)__ldg(slab + 1);
    return taps > KSTEP ? (taps + KSTEP - 1) / KSTEP : 1;
}

// Warp w of block (run, strip, limb): tiles TPW (w / ss) .. of each slab of
// the run, on coefficients n0 .. n0 + 7, n0 = 8 (strip ss + w % ss).  Each
// step (`lanes.step`: the lane's on the card, the warp's in the host
// build) loads and splits the step's words once for the warp's tiles,
// forms their products, then folds (end 1) or stores the tiles' outputs
// (end 2).
template <int DW, int TPW, class Lanes>
__device__ __forceinline__ void walk(const Args& a, long long run, long long strip, int l,
                                     int warp, Lanes& lanes) {
    const long long first = run * a.run, end = first + a.run < a.S ? first + a.run : a.S;
    const int ti = warp / a.ss * TPW, sk = (int)a.sk;
    const long long n0 = (strip * a.ss + warp % a.ss) * 8;
    const u64* c = a.consts + l * CONSTS;
    const int dx = (int)__ldg(c + 9);
    for (long long s = first; s < end; ++s) {
        const long long* slab = a.slabs + s * SLAB;
        const int left = (int)__ldg(slab + 3) - ti;  // the slab's tiles from the warp's on
        if (left <= 0) continue;
        const int steps = steps_of(slab);
        const int* col = a.col + __ldg(slab);
        const long long* tile = a.tiles + (__ldg(slab + 2) + ti) * TABLE;
        const u64* wd = a.wd + ((long long)l * a.WK + __ldg(tile + 3)) * DW * 32;
        for (int ch = 0, next = a.fold; ch < steps; ++ch, wd += DW * 32) {
            const int end = ch + 1 == steps ? 2 : --next == 0;
            next = next ? next : a.fold;
            lanes.step(col, sk, ch, wd, (long long)steps * DW * 32, left < TPW ? left : TPW, dx,
                       end, tile, n0, l, c, a);
        }
    }
}

// The C entries' arguments, checked: 0, or -2 for what the kernel does not
// take.  xstr: x's strides (k, l, n), the first below 2^31; dx: the most
// bytes of a limb's words; two tiles a warp (tpw) take 5 digits and 6
// bytes at most.
inline int make_args(Args& a, const void* x0, const void* x1, const long long* xstr,
                     const void* wd, const void* col, const void* tiles, const void* slabs,
                     const void* bias, const void* consts, void* out, long long S, long long WK,
                     long long J, long long N, int L, int dw, int dx, int tb, int tpw, int ss,
                     int run, int fold) {
    if (!x0 || !x1 || !xstr || (!wd && WK) || !col || !tiles || !slabs || !consts || !out ||
        S < 1 || WK < 0 || J < 1 || N < 1 || L < 1 || L > 65535 || dw < 1 || dw > 8 || dx < 1 ||
        dx > 8 || tb < 1 || tpw < 1 || tpw > 2 || (tpw == 2 && (dw > 5 || dx > 6)) || ss < 1 ||
        (tb + tpw - 1) / tpw * ss > MAX_WARPS || run < 1 || fold < 1 || xstr[0] < 0 ||
        xstr[0] > 0x7fffffffLL)
        return -2;
    a = Args{(const u64*)x0, (const u64*)x1, xstr[0], xstr[1], xstr[2], (const u64*)wd,
             (const int*)col, (const long long*)tiles, (const long long*)slabs, (const u64*)bias,
             (const u64*)consts, (u64*)out, S, WK, J, N, L, dw, tb, tpw, ss, run, fold};
    return 0;
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

struct TensorCore {
    // c += a (u8, 16 x 32) * b (s8, 32 x 8)
    __device__ __forceinline__ void operator()(int (&c)[4], const Frag& a, u64 b) const {
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0, %1, %2, %3}, "
            "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
            : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"((unsigned)b),
              "r"((unsigned)(b >> 32)));
    }
};

// One lane of a warp on the card: its planes and its step.
template <int DW, int DXM, int TPW>
struct Lane {
    static constexpr int E = DW + DXM - 1;
    int lane;
    const u64 *x0, *x1;  // the lane's coefficient of x_h at the limb (the last one past N)
    int acc[TPW][E][4];
    __device__ __forceinline__ void step(const int* col, int sk, int ch, const u64* wd,
                                         long long stride, int tiles, int dx, int end,
                                         const long long* tile, long long n0, int l,
                                         const u64* c, const Args& a) {
        u64 w[2][2][4];
        load_words(col, sk, ch, x0, x1, lane, w);
        Frag f[DXM];
        split<DXM>(w, dx, f);
#pragma unroll
        for (int t = 0; t < TPW; ++t) {
            if (t < tiles) {
                u64 b[DW];
                load_b<DW>(wd + t * stride + lane, b);
                products<DW, DXM>(acc[t], f, b, dx, TensorCore());
                if (end == 2)
                    store<E>(a, tile + t * TABLE, l, n0, lane, acc[t], limb_of(c));
                else if (end)
                    fold<E>(acc[t], limb_of(c));
            }
        }
    }
};

// blockIdx.x: a run of slabs; blockIdx.y: a strip of 8 ss coefficients;
// blockIdx.z: the limb.  Each warp walks the run on its own (no shared
// memory, no barrier).  DW: the digits; DXM: the most bytes; TPW: tiles
// a warp.
template <int DW, int DXM, int TPW>
__global__ void __launch_bounds__(32 * MAX_WARPS, TPW == 1 ? 3 : 2) ct_matrix_kernel(const Args a) {
    const int l = blockIdx.z, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long n = ((long long)blockIdx.y * a.ss + warp % a.ss) * 8 + (lane >> 2);
    const long long at = l * a.sl + (n < a.N ? n : a.N - 1) * a.sn;
    Lane<DW, DXM, TPW> lanes{lane, a.x0 + at, a.x1 + at, {}};
    walk<DW, TPW>(a, blockIdx.x, blockIdx.y, l, warp, lanes);
}

template <int DW, int DXM, int TPW>
static cudaError_t launch(const Args& a, cudaStream_t stream) {
    const dim3 grid((unsigned)((a.S + a.run - 1) / a.run),
                    (unsigned)((a.N + 8 * a.ss - 1) / (8 * a.ss)), (unsigned)a.L);
    const int warps = (a.tb + TPW - 1) / TPW * a.ss;
    ct_matrix_kernel<DW, DXM, TPW><<<grid, 32 * warps, 0, stream>>>(a);
    return cudaGetLastError();
}

template <int DXM>
static cudaError_t launch(const Args& a, cudaStream_t stream) {
    if (DXM == 6 && a.tpw == 2) switch (a.dw) {
            case 1: return launch<1, 6, 2>(a, stream);
            case 2: return launch<2, 6, 2>(a, stream);
            case 3: return launch<3, 6, 2>(a, stream);
            case 4: return launch<4, 6, 2>(a, stream);
            default: return launch<5, 6, 2>(a, stream);
        }
    switch (a.dw) {
        case 1: return launch<1, DXM, 1>(a, stream);
        case 2: return launch<2, DXM, 1>(a, stream);
        case 3: return launch<3, DXM, 1>(a, stream);
        case 4: return launch<4, DXM, 1>(a, stream);
        case 5: return launch<5, DXM, 1>(a, stream);
        case 6: return launch<6, DXM, 1>(a, stream);
        case 7: return launch<7, DXM, 1>(a, stream);
        default: return launch<8, DXM, 1>(a, stream);
    }
}

// Returns -2 for an argument the kernel does not take, else the CUDA error
// of the launch.
extern "C" int ct_matrix_launch(const void* x0, const void* x1, const long long* xstr,
                                const void* wd, const void* col, const void* tiles,
                                const void* slabs, const void* bias, const void* consts,
                                void* out, long long S, long long WK, long long J, long long N,
                                int L, int dw, int dx, int tb, int tpw, int ss, int run,
                                int fold, void* stream) {
    Args a;
    if (make_args(a, x0, x1, xstr, wd, col, tiles, slabs, bias, consts, out, S, WK, J, N, L, dw,
                  dx, tb, tpw, ss, run, fold) ||
        (S + run - 1) / run > 0x7fffffffLL || (N + 8 * ss - 1) / (8 * ss) > 65535)
        return -2;
    const cudaStream_t st = (cudaStream_t)stream;
    return (int)(dx <= 6 ? launch<6>(a, st) : launch<8>(a, st));
}
#endif  // __CUDACC__
