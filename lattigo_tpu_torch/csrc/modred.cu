// The elementwise modular pass: one launch computes one of the Montgomery /
// Barrett / conditional reductions of ops/modred.py, or one of the fused
// forms the ring's coefficient methods need, over a whole [B, L, N] tensor.
//
// No TPU kernel: under jax.jit, XLA fuses each chain of
// lattigo_tpu/ops/modred.py (mred :71 and the rest) with the adds around it
// into one device pass over the coefficients.  The port ran the same chains
// as plain PyTorch ops, about 58 elementwise passes for one mred
// (ops/u64.mul64_128 builds each 64 x 64 -> 128 product from 32-bit
// halves); this kernel is that one pass.  It computes exactly the plain
// version (ops/modred.py, and the compositions in ops/modred_kernel.py)
// bit for bit, for any 64-bit inputs: every operation wraps mod 2^64.
//
// Operands: up to three coefficient operands (x, y, z) and four per-limb
// constants (q, qinv, u0, u1), each a pointer and its strides over the
// collapsed [B, L, N] view of the output (stride 0 where it broadcasts);
// ops/modred_kernel.launch_plan makes them.
//
// Bound on the H100: the bytes (each operand read once, the output written
// once, at 3.35 TB/s); a Montgomery product is 14 int32 multiplies, 8 bytes
// of output need 5,000 such multiplies before they bound it.  What the
// design does about it: one thread an element, neighbouring threads on
// neighbouring coefficients (a warp reads 256 contiguous bytes of each
// operand with a unit stride); the 64 x 64 -> 128 products are
// __umul64hi and one low multiply; constants broadcast along a row are the
// same word for the whole warp.
#include <cstdint>
#include "modarith.cuh"

// op codes: keep in step with OPS in ops/modred_kernel.py
enum Op {
    CRED = 0,           // cred(x)
    MRED = 1,           // x * y * 2^-64 mod q
    MRED_CONSTANT = 2,  // the same in [0, 2q)
    MFORM = 3,          // x * 2^64 mod q
    INV_MFORM = 4,      // x * 2^-64 mod q
    BRED_ADD = 5,       // x mod q
    BRED = 6,           // x * y mod q
    ADD = 7,            // cred(x + y)
    SUB = 8,            // cred(x + q - y)
    NEG = 9,            // q - x
    MRED_ADD = 10,      // cred(mred(x, y) + z)
    MRED_SUB = 11,      // cred(q - mred(x, y) + z)
    MRED_ADD_LAZY = 12, // mred(x, y) + z
    MRED_DIFF = 13,     // mred(x + (q - y), z)
    ADD_BRED = 14,      // bred_add(x + y)
    N_OPS = 15
};

enum Slot { X = 0, Y, Z, Q, QINV, U0, U1, SLOTS };

struct Operand {
    const u64* p;
    long long sb, sl, sn;  // strides of the [B, L, N] view, in elements
};

struct Args {
    Operand o[SLOTS];
    u64* out;  // [B, L, N], contiguous
    long long rows, L, N;  // rows = B * L
};

constexpr int THREADS = 256;
constexpr long long MAX_GRID_Y = 65535;

// x * y mod q in [0, 2q) for any 64-bit x, y (ops/modred.py bred_constant)
__device__ __forceinline__ u64 bred_lazy(u64 x, u64 y, u64 q, u64 u0, u64 u1) {
    const u64 alo = x * y, ahi = __umul64hi(x, y);
    const u64 lhi = __umul64hi(alo, u1);
    const u64 mlo = alo * u0, mhi = __umul64hi(alo, u0);
    const u64 s0 = mlo + lhi;
    const u64 s1 = mhi + (s0 < lhi);
    const u64 mlo2 = ahi * u1, mhi2 = __umul64hi(ahi, u1);
    const u64 lhi2 = mhi2 + ((mlo2 + s0) < s0);
    return alo - (ahi * u0 + s1 + lhi2) * q;
}

// op OP on one element; at(slot) gives the element's operand of a slot
// (read only for the slots the op takes)
template <int OP, class At>
__device__ __forceinline__ u64 apply(const At& at) {
    const u64 q = at(Q);
    if constexpr (OP == CRED) return cred(at(X), q);
    if constexpr (OP == MRED) return mred(at(X), at(Y), q, at(QINV));
    if constexpr (OP == MRED_CONSTANT) return mred_lazy(at(X), at(Y), q, at(QINV));
    if constexpr (OP == MFORM) {
        const u64 x = at(X);
        return cred((0 - (x * at(U0) + __umul64hi(x, at(U1)))) * q, q);
    }
    if constexpr (OP == INV_MFORM) return cred(q - __umul64hi(at(X) * at(QINV), q), q);
    if constexpr (OP == BRED_ADD) return bred_add(at(X), q, at(U0));
    if constexpr (OP == BRED) return cred(bred_lazy(at(X), at(Y), q, at(U0), at(U1)), q);
    if constexpr (OP == ADD) return cred(at(X) + at(Y), q);
    if constexpr (OP == SUB) return cred(at(X) + q - at(Y), q);
    if constexpr (OP == NEG) return q - at(X);
    if constexpr (OP == MRED_ADD) return cred(mred(at(X), at(Y), q, at(QINV)) + at(Z), q);
    if constexpr (OP == MRED_SUB) return cred(q - mred(at(X), at(Y), q, at(QINV)) + at(Z), q);
    if constexpr (OP == MRED_ADD_LAZY) return mred(at(X), at(Y), q, at(QINV)) + at(Z);
    if constexpr (OP == MRED_DIFF) return mred(at(X) + (q - at(Y)), at(Z), q, at(QINV));
    if constexpr (OP == ADD_BRED) return bred_add(at(X) + at(Y), q, at(U0));
    return 0;
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

// blockIdx.x: a chunk of THREADS coefficients of a row; blockIdx.y: rows
// b * L + l, strided by gridDim.y
template <int OP>
__global__ void __launch_bounds__(THREADS) modred_kernel(const Args a) {
    const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= a.N) return;
    for (long long r = blockIdx.y; r < a.rows; r += gridDim.y) {
        const long long b = r / a.L, l = r - b * a.L;
        const auto at = [&](int s) -> u64 {
            const Operand& o = a.o[s];
            return o.p[b * o.sb + l * o.sl + n * o.sn];
        };
        a.out[r * a.N + n] = apply<OP>(at);
    }
}

template <int OP>
static void launch(const Args& a, dim3 grid, int threads, cudaStream_t stream) {
    modred_kernel<OP><<<grid, threads, 0, stream>>>(a);
}

typedef void (*Launcher)(const Args&, dim3, int, cudaStream_t);
static const Launcher LAUNCHERS[N_OPS] = {
    launch<0>, launch<1>, launch<2>, launch<3>, launch<4>, launch<5>, launch<6>, launch<7>,
    launch<8>, launch<9>, launch<10>, launch<11>, launch<12>, launch<13>, launch<14>,
};

// desc: SLOTS x (pointer, sb, sl, sn) on the host; an unused slot has a
// null pointer.  Returns -2 for an argument the kernel does not take, else
// the CUDA error of the launch.
extern "C" int modred_launch(int op, const long long* desc, void* out, long long B, long long L,
                             long long N, void* stream) {
    if (op < 0 || op >= N_OPS || B < 1 || L < 1 || N < 1 || desc == nullptr || out == nullptr ||
        desc[4 * Q] == 0)
        return -2;
    Args a;
    for (int s = 0; s < SLOTS; ++s)
        a.o[s] = Operand{(const u64*)desc[4 * s], desc[4 * s + 1], desc[4 * s + 2],
                         desc[4 * s + 3]};
    a.out = (u64*)out;
    a.rows = B * L;
    a.L = L;
    a.N = N;
    const int threads = N >= THREADS ? THREADS : (int)((N + 31) / 32 * 32);
    const dim3 grid((unsigned)((N + threads - 1) / threads),
                    (unsigned)(a.rows < MAX_GRID_Y ? a.rows : MAX_GRID_Y));
    LAUNCHERS[op](a, grid, threads, (cudaStream_t)stream);
    return (int)cudaGetLastError();
}
#endif  // __CUDACC__
