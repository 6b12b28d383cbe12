/* Exact byte-consumption-order rejection walk of the CRP stream.
 *
 * Native counterpart of the per-coefficient loop in ring/prng.go:77-103
 * (Clock): for each coefficient i (outer) and modulus j (inner), consume
 * 8-byte big-endian words until (word & mask[j]) < q[j].
 *
 * W:      decoded word stream (M entries)
 * out:    L x N array, out[j*N + i]
 * return: number of words consumed, or -1 if W was exhausted.
 */
#include <stdint.h>

long long crp_walk(const uint64_t *W, long long M,
                   const uint64_t *masks, const uint64_t *qs, long long L,
                   long long N, uint64_t *out) {
    long long k = 0;
    for (long long i = 0; i < N; i++) {
        for (long long j = 0; j < L; j++) {
            for (;;) {
                if (k >= M) return -1;
                uint64_t c = W[k++] & masks[j];
                if (c < qs[j]) {
                    out[j * N + i] = c;
                    break;
                }
            }
        }
    }
    return k;
}
