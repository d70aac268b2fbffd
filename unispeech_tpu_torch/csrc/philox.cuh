// Philox-4x32-10 counter-based random numbers (Salmon et al., SC 2011), the
// device half of unispeech_tpu_torch/ops/kernels/philox.py: the same words
// bit for bit, so a kernel's dropout mask and its plain version's agree.
#pragma once

#include <stdint.h>

namespace usk {

struct Philox4 {
    uint32_t x[4];
};

__device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2,
                                                 uint32_t c3, uint32_t k0, uint32_t k1) {
#pragma unroll
    for (int r = 0; r < 10; ++r) {
        if (r) {
            k0 += 0x9E3779B9u;
            k1 += 0xBB67AE85u;
        }
        const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
        const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
        const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
        c0 = n0;
        c1 = lo1;
        c2 = n2;
        c3 = lo0;
    }
    Philox4 out;
    out.x[0] = c0;
    out.x[1] = c1;
    out.x[2] = c2;
    out.x[3] = c3;
    return out;
}

// Attention dropout: element (b, h, t, s) is kept iff word
// (s & 1) | (t & 1) << 1 of philox(counter (s >> 1, t >> 1, h, b), key =
// the 64-bit seed's low and high words) is >= threshold = floor(rate * 2^32).
// Returns the two words of row t for the column pair (s, s + 1), s even.
__device__ __forceinline__ void attention_keep_pair(uint64_t seed, uint32_t threshold,
                                                    int b, int h, int t, int s,
                                                    bool& keep0, bool& keep1) {
    const Philox4 w = philox4x32_10((uint32_t)(s >> 1), (uint32_t)(t >> 1), (uint32_t)h,
                                    (uint32_t)b, (uint32_t)seed, (uint32_t)(seed >> 32));
    const int base = (t & 1) << 1;
    keep0 = w.x[base] >= threshold;
    keep1 = w.x[base + 1] >= threshold;
}

// The same mask read along a column pair: rows t, t + 1 (t even) of key s.
__device__ __forceinline__ void attention_keep_colpair(uint64_t seed, uint32_t threshold,
                                                       int b, int h, int t, int s,
                                                       bool& keep0, bool& keep1) {
    const Philox4 w = philox4x32_10((uint32_t)(s >> 1), (uint32_t)(t >> 1), (uint32_t)h,
                                    (uint32_t)b, (uint32_t)seed, (uint32_t)(seed >> 32));
    keep0 = w.x[s & 1] >= threshold;
    keep1 = w.x[(s & 1) | 2] >= threshold;
}

}  // namespace usk
