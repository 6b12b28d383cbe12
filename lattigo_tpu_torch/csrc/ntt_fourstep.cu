// Four-step negacyclic NTT with exact int8 tensor-core digit products.
//
// Replaces the TPU kernel `ntt_mxu` (lattigo_tpu/ops/mxu_ntt.py:465, body
// `_compute_block` :270).  With N = n1 x 128 and x2d[j1, j2] the transform is
//
//     out2d = ((M_rows @ x2d) * T) @ M_lanes   (mod q)        forward
//     out2d = M_rows @ ((x2d @ M_lanes) * T)   (mod q)        inverse
//
// Each modular product is one int8 GEMM over byte digits: the data enter as
// their raw bytes (u8), the matrices hold 8 x 8 balanced s8 digit blocks, and
// the result leaves as 8 s32 digit planes e that are recombined in uint64.
// Row r of x carries limb limbs[r % L]; the polys of limb position k (rows k,
// k + L, ...) share that limb's matrices, so each product is one GEMM per
// limb whose other dimension runs over all of those polys:
//
//   rows:  C[(e,a), (p,j2)] = sum_(b,d) Mr[(e,a), (b,d)] * byte_d(x[p,b,j2])
//   lanes: C[(p,j1), (e,c)] = sum_(j2,d) byte_d(x[p,j1,j2]) * Ml[(j2,d), (e,c)]
//
// Contraction order (b, d) / (j2, d): 4 consecutive contraction indices are 4
// consecutive bytes of one little-endian u64, exactly what an m16n8k32
// fragment register holds, so the data are copied as they lie in memory (no
// digitise pass) and multiplied as u8 against s8 (`mma.sync ... s8.u8` /
// `u8.s8`).  The JAX planes use (u - 128) with a correction 128 * sum(M) +
// off; here the plane is sum(M * u) + off, the same integer.  The matrices
// are stored in fragment order (ops/mxu_ntt.py `rows_layout` /
// `lanes_layout`): each lane's registers of one fragment are 16 contiguous
// bytes, a warp's 512, so a block's strip is a few contiguous runs and every
// fragment read is conflict-free.
//
// Both kernels run a 4-stage ring of cp.async copies (64 contraction bytes a
// stage) into shared memory, mma.sync from shared memory, and an epilogue
// from registers: a thread's accumulators hold all 8 planes of the same
// outputs, so the recombination, the twiddle (first product) or the final
// exact reduction (second) run without a scratch round trip.  Two launches a
// transform, the [rows, n1, 128] intermediate in device memory.
//
// Bound on the H100 (chip_smoke.py `bound_ms`): the larger of the int8
// operations 2 (8 n1)^2 128 + 2 n1 1024^2 per row at 1,979 T/s and the bytes
// (16 N per row plus the limbs' tables) at 3.35 TB/s: operations at N = 16384,
// bytes at N = 4096 and at [2, 12, 32768].  The design's answer to the
// operations is tiles that feed the tensor cores from shared memory (each
// matrix byte fetched from L2 serves 128 output columns or rows, each data
// byte 32 a or c of all 8 planes) with copies in flight behind the mma; to
// the bytes, that the data are read and written once a product.  mma.sync
// reaches about half the int8 peak; wgmma is the way to the rest.
#include <cuda_runtime.h>
#include "modarith.cuh"

constexpr int DIG = 8;       // byte digits of a 64-bit word
constexpr int N2 = 128;      // lane-axis transform length
constexpr int THREADS = 256; // 8 warps a block
constexpr int STAGES = 4;    // depth of the cp.async ring
constexpr int FRAG = 512;    // bytes of one fragment set: 32 lanes x 16
constexpr int KSTAGE = 2;    // k32 steps a stage (64 contraction bytes)

// rows kernel: 2 warps along a (16 rows each, all 8 planes), 4 along columns
// (32 columns each); a block is 32 a x one poly's 128 columns
constexpr int R_AT = 2;
constexpr int R_MAT = R_AT * KSTAGE * DIG * FRAG;  // matrix strip of a stage
constexpr int R_BROW = DIG * N2 + 64;  // one b row of data, padded: conflict-free
constexpr int R_STAGE = R_MAT + KSTAGE * 4 * R_BROW;

// lanes kernel: 2 warps along rows (64 rows each), 4 along columns (8 columns
// of all 8 planes each); a block is 128 rows x 32 columns
constexpr int L_BM = 128;
constexpr int L_CT = 4;
constexpr int L_MAT = L_CT * KSTAGE * (DIG / 2) * FRAG;
constexpr int L_AROW = KSTAGE * 32 + 16;  // one data row of a stage, padded
constexpr int L_STAGE = L_MAT + L_BM * L_AROW;
constexpr int L_KT = DIG * N2 / (32 * KSTAGE);  // stages over the 1024 bytes

// consts: [L_ring, 8] = q, 2^40 mod q, its Shoup word, final offset
// correction, floor(2^128/q) >> 64, rows plane offset, lanes plane offset.
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

// The epilogue of two neighbouring outputs (pos, pos + 1) of one row from
// their planes: middle twiddle (lazy) or the final exact reduction, stored as
// one 16-byte write.  tw: [3, n] = twiddle, Shoup word, correction.
template <bool FINAL>
__device__ __forceinline__ void store_pair(u64* dst, const u64 p0[DIG], const u64 p1[DIG],
                                           const LimbConsts& k, const u64* __restrict__ tw,
                                           int n, int pos) {
    u64 v0 = combine(p0, k), v1 = combine(p1, k);
    if (FINAL) {
        v0 = bred_add(v0 + k.cf, k.q, k.u0);
        v1 = bred_add(v1 + k.cf, k.q, k.u0);
    } else {
        const ulonglong2 w = *reinterpret_cast<const ulonglong2*>(tw + pos);
        const ulonglong2 ws = *reinterpret_cast<const ulonglong2*>(tw + n + pos);
        const ulonglong2 wc = *reinterpret_cast<const ulonglong2*>(tw + 2 * n + pos);
        v0 = mul_shoup(v0, w.x, ws.x, k.q) + wc.x;
        v1 = mul_shoup(v1, w.y, ws.y, k.q) + wc.y;
    }
    *reinterpret_cast<ulonglong2*>(dst + pos) = make_ulonglong2(v0, v1);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A fragment (16 x 32 bytes, row-major) of rows [0, 16) of a shared tile
// whose rows are `stride` bytes apart.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&a)[4], const unsigned char* base,
                                            int stride, int lane) {
    const unsigned char* p = base + ((lane & 7) + ((lane >> 3) & 1) * 8) * stride + (lane >> 4) * 16;
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
                 : "r"(smem_addr(p)));
}

// c += a (s8, 16 x 32) * b (u8, 32 x 8)
__device__ __forceinline__ void mma_s8u8(int (&c)[4], const uint4& a, unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// c += a (u8, 16 x 32) * b (s8, 32 x 8)
__device__ __forceinline__ void mma_u8s8(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows product.  grid (P polys of a limb, n1 / 32, L); block (p, a tile, k)
// computes out[p*L + k][a][j2] for a in the tile, every j2.
// Matrix m_rows[limb]: [a/16][k/32][e][lane][16], k = 8 b + d.
template <bool FINAL>
__global__ void __launch_bounds__(THREADS, 1)
rows_mm_kernel(const u64* __restrict__ x, u64* __restrict__ out,
               const unsigned char* __restrict__ m_rows, const u64* __restrict__ ttab,
               const u64* __restrict__ consts, const int* __restrict__ limbs, int L, int n1) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int p = blockIdx.x, at0 = blockIdx.y * R_AT, kpos = blockIdx.z;
    const int limb = limbs[kpos];
    const int n = n1 * N2, row = p * L + kpos;
    const int ks_all = n1 / 4;            // k32 steps: K = 8 n1 bytes
    const int kt_all = ks_all / KSTAGE;   // ring stages
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp & 1, wn = warp >> 1, g = lane >> 2, t = lane & 3;

    const unsigned char* xb = reinterpret_cast<const unsigned char*>(x + (size_t)row * n);
    const size_t at_bytes = (size_t)ks_all * DIG * FRAG;
    const unsigned char* mb = m_rows + (size_t)limb * 64 * n1 * n1 + at0 * at_bytes;

    auto load = [&](int s) {
        unsigned char* st = smem + (s % STAGES) * R_STAGE;
        constexpr int chunks = KSTAGE * DIG * FRAG / 16;  // of one a tile
#pragma unroll
        for (int i = 0; i < R_MAT / 16 / THREADS; ++i) {
            const int c = tid + i * THREADS;
            cp_async16(st + c * 16, mb + (c / chunks) * at_bytes +
                                        (size_t)s * KSTAGE * DIG * FRAG + (c % chunks) * 16);
        }
#pragma unroll
        for (int i = 0; i < KSTAGE * 4 * DIG * N2 / 16 / THREADS; ++i) {
            const int c = tid + i * THREADS, bl = c >> 6, o = (c & 63) * 16;
            cp_async16(st + R_MAT + bl * R_BROW + o,
                       xb + (size_t)(s * KSTAGE * 4 + bl) * DIG * N2 + o);
        }
    };

    int acc[DIG][4][4];
#pragma unroll
    for (int e = 0; e < DIG; ++e)
#pragma unroll
        for (int f = 0; f < 4; ++f)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[e][f][i] = 0;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < kt_all) load(s);
        cp_async_commit();
    }
    for (int kt = 0; kt < kt_all; ++kt) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        if (kt + STAGES - 1 < kt_all) load(kt + STAGES - 1);
        cp_async_commit();
        const unsigned char* st = smem + (kt % STAGES) * R_STAGE;
#pragma unroll
        for (int kk = 0; kk < KSTAGE; ++kk) {
            // B: column j2 = wn*32 + f*8 + g, contraction bytes 4t.. of b
            // rows (4 kk + t/2) and (4 kk + 2 + t/2), byte 4 (t & 1)
            unsigned b[4][2];
            const unsigned char* dp = st + R_MAT + (kk * 4 + (t >> 1)) * R_BROW +
                                      (wn * 32 + g) * 8 + (t & 1) * 4;
#pragma unroll
            for (int f = 0; f < 4; ++f) {
                b[f][0] = *reinterpret_cast<const unsigned*>(dp + f * 64);
                b[f][1] = *reinterpret_cast<const unsigned*>(dp + f * 64 + 2 * R_BROW);
            }
            const unsigned char* mp = st + (wm * KSTAGE + kk) * DIG * FRAG + lane * 16;
#pragma unroll
            for (int e = 0; e < DIG; ++e) {
                const uint4 a = *reinterpret_cast<const uint4*>(mp + e * FRAG);
#pragma unroll
                for (int f = 0; f < 4; ++f) mma_s8u8(acc[e][f], a, b[f][0], b[f][1]);
            }
        }
    }
    cp_async_wait<0>();

    const LimbConsts k = load_consts(consts, limb);
    const int off = (int)consts[8 * limb + 5];
    const u64* tw = ttab + (size_t)limb * 3 * n;
    u64* dst = out + (size_t)row * n;
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int a = (at0 + wm) * 16 + g + 8 * h;
            u64 p0[DIG], p1[DIG];
#pragma unroll
            for (int e = 0; e < DIG; ++e) {
                p0[e] = (u64)(unsigned)(acc[e][f][2 * h] + off);
                p1[e] = (u64)(unsigned)(acc[e][f][2 * h + 1] + off);
            }
            store_pair<FINAL>(dst, p0, p1, k, tw, n, a * N2 + wn * 32 + f * 8 + 2 * t);
        }
}

// Lanes product.  grid (ceil(P n1 / 128), 128 / 32, L); block (r tile, c
// tile, k) computes out[p*L + k][j1][c] for the 128 (p, j1) rows r = p n1 +
// j1 of the tile (masked past P n1) and 32 columns c.
// Matrix m_lanes[limb]: [c/8][k/32][e/2][lane][16], k = 8 j2 + d.
template <bool FINAL>
__global__ void __launch_bounds__(THREADS, 1)
lanes_mm_kernel(const u64* __restrict__ x, u64* __restrict__ out,
                const unsigned char* __restrict__ m_lanes, const u64* __restrict__ ttab,
                const u64* __restrict__ consts, const int* __restrict__ limbs, int L, int n1,
                int polys) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int r0 = blockIdx.x * L_BM, ct0 = blockIdx.y * L_CT, kpos = blockIdx.z;
    const int limb = limbs[kpos];
    const int n = n1 * N2, lg = __ffs(n1) - 1, rows_k = polys * n1;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp & 1, wn = warp >> 1, g = lane >> 2, t = lane & 3;

    // each thread copies 16 bytes of two data rows a stage
    const unsigned char* src[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = min(r0 + (tid >> 2) + 64 * i, rows_k - 1);
        src[i] = reinterpret_cast<const unsigned char*>(
                     x + ((size_t)((r >> lg) * L + kpos) * n1 + (r & (n1 - 1))) * N2) +
                 (tid & 3) * 16;
    }
    constexpr size_t ct_bytes = (size_t)(DIG * N2 / 32) * (DIG / 2) * FRAG;
    const unsigned char* mb = m_lanes + (size_t)limb * (DIG * N2) * (DIG * N2) + ct0 * ct_bytes;

    auto load = [&](int s) {
        unsigned char* st = smem + (s % STAGES) * L_STAGE;
        constexpr int chunks = KSTAGE * (DIG / 2) * FRAG / 16;  // of one c octet
#pragma unroll
        for (int i = 0; i < L_MAT / 16 / THREADS; ++i) {
            const int c = tid + i * THREADS;
            cp_async16(st + c * 16, mb + (c / chunks) * ct_bytes +
                                        (size_t)s * KSTAGE * (DIG / 2) * FRAG + (c % chunks) * 16);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
            cp_async16(st + L_MAT + ((tid >> 2) + 64 * i) * L_AROW + (tid & 3) * 16,
                       src[i] + s * KSTAGE * 32);
    };

    int acc[4][DIG][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int e = 0; e < DIG; ++e)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[m][e][i] = 0;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        load(s);
        cp_async_commit();
    }
    for (int kt = 0; kt < L_KT; ++kt) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        if (kt + STAGES - 1 < L_KT) load(kt + STAGES - 1);
        cp_async_commit();
        const unsigned char* st = smem + (kt % STAGES) * L_STAGE;
#pragma unroll
        for (int kk = 0; kk < KSTAGE; ++kk) {
            unsigned a[4][4];
#pragma unroll
            for (int m = 0; m < 4; ++m)
                ldmatrix_x4(a[m], st + L_MAT + (wm * 64 + m * 16) * L_AROW + kk * 32, L_AROW, lane);
            const unsigned char* mp = st + (wn * KSTAGE + kk) * (DIG / 2) * FRAG + lane * 16;
#pragma unroll
            for (int ep = 0; ep < DIG / 2; ++ep) {
                const uint4 bv = *reinterpret_cast<const uint4*>(mp + ep * FRAG);
#pragma unroll
                for (int m = 0; m < 4; ++m) {
                    mma_u8s8(acc[m][2 * ep], a[m], bv.x, bv.y);
                    mma_u8s8(acc[m][2 * ep + 1], a[m], bv.z, bv.w);
                }
            }
        }
    }
    cp_async_wait<0>();

    const LimbConsts k = load_consts(consts, limb);
    const int off = (int)consts[8 * limb + 6];
    const u64* tw = ttab + (size_t)limb * 3 * n;
    const int c = (ct0 + wn) * 8 + 2 * t;
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = r0 + wm * 64 + m * 16 + g + 8 * h;
            if (r >= rows_k) continue;
            const int j1 = r & (n1 - 1);
            u64 p0[DIG], p1[DIG];
#pragma unroll
            for (int e = 0; e < DIG; ++e) {
                p0[e] = (u64)(unsigned)(acc[m][e][2 * h] + off);
                p1[e] = (u64)(unsigned)(acc[m][e][2 * h + 1] + off);
            }
            u64* dst = out + (size_t)((r >> lg) * L + kpos) * n;
            store_pair<FINAL>(dst, p0, p1, k, tw, n, j1 * N2 + c);
        }
}

template <typename Kernel, typename... Args>
static cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                          Args... args) {
    // above 48 KB the dynamic shared memory has to be granted explicitly
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, THREADS, smem, stream>>>(args...);
    return cudaGetLastError();
}

// x, mid, out: [rows = P*L, n1, 128] uint64, 16-byte aligned (row r carries
// limb table limbs[r % L]); m_rows [L_ring, (8 n1)^2] and m_lanes
// [L_ring, 1024^2] s8 in fragment order; ttab [L_ring, 3, n1*128] u64;
// consts [L_ring, 8] u64.  Returns the CUDA error code of the launches
// (0 = both launched).
extern "C" int ntt_fourstep_launch(const void* x, void* mid, void* out, const void* m_rows,
                                   const void* m_lanes, const void* ttab, const void* consts,
                                   const void* limbs, int rows, int L, int n1, int inverse,
                                   void* stream_) {
    cudaStream_t stream = (cudaStream_t)stream_;
    const int polys = rows / L;
    const dim3 rows_grid(polys, n1 / (16 * R_AT), L);
    const dim3 lanes_grid((polys * n1 + L_BM - 1) / L_BM, N2 / (8 * L_CT), L);
    const size_t rows_smem = (size_t)STAGES * R_STAGE, lanes_smem = (size_t)STAGES * L_STAGE;
    const u64* xs = (const u64*)x;
    u64* ms = (u64*)mid;
    u64* os = (u64*)out;
    const unsigned char* mr = (const unsigned char*)m_rows;
    const unsigned char* ml = (const unsigned char*)m_lanes;
    const u64* tt = (const u64*)ttab;
    const u64* cs = (const u64*)consts;
    const int* lv = (const int*)limbs;
    cudaError_t err;
    if (!inverse) {
        err = launch(rows_mm_kernel<false>, rows_grid, rows_smem, stream, xs, ms, mr, tt, cs, lv,
                     L, n1);
        if (err != cudaSuccess) return (int)err;
        err = launch(lanes_mm_kernel<true>, lanes_grid, lanes_smem, stream, (const u64*)ms, os, ml,
                     tt, cs, lv, L, n1, polys);
    } else {
        err = launch(lanes_mm_kernel<false>, lanes_grid, lanes_smem, stream, xs, ms, ml, tt, cs,
                     lv, L, n1, polys);
        if (err != cudaSuccess) return (int)err;
        err = launch(rows_mm_kernel<true>, rows_grid, rows_smem, stream, (const u64*)ms, os, mr,
                     tt, cs, lv, L, n1);
    }
    return (int)err;
}
