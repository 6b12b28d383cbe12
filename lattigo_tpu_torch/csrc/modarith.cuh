// 64-bit modular arithmetic shared by the kernels.  All values are uint64
// and every operation wraps mod 2^64, as the plain PyTorch versions
// (ops/modred.py) do; lazy values stay below 2^63 for moduli below 2^61.
#pragma once
#include <cstdint>

typedef unsigned long long u64;

#ifndef __CUDACC__
// A host C++ build of the arithmetic: tools/host_build.py compiles the
// modular kernels' sources with the host compiler, the CUDA parts left out.
#define __device__
#define __forceinline__ inline
static inline u64 __umul64hi(u64 a, u64 b) { return (u64)(((unsigned __int128)a * b) >> 64); }
#endif

// v * w mod q in [0, 2q) for any 64-bit v, with ws = floor(w * 2^64 / q).
__device__ __forceinline__ u64 mul_shoup(u64 v, u64 w, u64 ws, u64 q) {
    return v * w - __umul64hi(v, ws) * q;
}

// a - 2q where a > 2q (the reference's lazy fold: 2q itself stays).
__device__ __forceinline__ u64 fold2q(u64 a, u64 two_q) {
    return a > two_q ? a - two_q : a;
}

// a mod q for a in [0, 2q).
__device__ __forceinline__ u64 cred(u64 a, u64 q) {
    return a >= q ? a - q : a;
}

// x mod q for any 64-bit x, with u0 = floor(2^128 / q) >> 64.
__device__ __forceinline__ u64 bred_add(u64 x, u64 q, u64 u0) {
    return cred(x - __umul64hi(x, u0) * q, q);
}

// x * y * 2^-64 mod q in [0, 2q), with qinv = q^-1 mod 2^64 (Montgomery).
__device__ __forceinline__ u64 mred_lazy(u64 x, u64 y, u64 q, u64 qinv) {
    return __umul64hi(x, y) - __umul64hi(x * y * qinv, q) + q;
}

// x * y * 2^-64 mod q in [0, q).
__device__ __forceinline__ u64 mred(u64 x, u64 y, u64 q, u64 qinv) {
    return cred(mred_lazy(x, y, q, qinv), q);
}
