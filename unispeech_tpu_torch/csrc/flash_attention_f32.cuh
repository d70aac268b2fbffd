// Shared pieces of the fp32 attention forward (flash_attention_f32.cu, which
// holds the width 64 and the entry; flash_attention_f32_mid.cu, the widths
// 80 and 96; flash_attention_f32_wide.cu, the width 128; each a translation
// unit of its own so that nvcc builds them at once): constants, the
// kernels' arguments, the split store, the per-step pieces of the width-80 /
// width-96 and width-128 forms, their launches.
#pragma once

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"
#include "philox.cuh"
#include "tf32.cuh"

namespace usk_attn_fwd_f32 {

constexpr int kBKey = 64;  // keys per step
constexpr int kMaxHd = 128;
constexpr int kMidMaxHd = 96;  // the widest head of the width-80 / width-96 form
// the padded-key logit: -2^100 absorbs any finite logit it is added to, so
// an all-padded row is uniform over its keys, as the plain softmax's
constexpr float kPadNeg = -1267650600228229401496703205376.0f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTileWords = 64;    // the open-tile bits: 2,048 key tiles; tiles past them all run
constexpr int kSmemMax = 232448;  // a block's shared memory on the H100

struct Args {
    const float *q, *k, *v;
    float* out;
    long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs;
    const float* bias;  // (H, T, S) rows bias_rs apart, heads T rows apart
    long long bias_rs;
    const float* gate;     // (B, H, T) or null
    const uint8_t* kpm;    // (B, S) or null
    const float* amask;    // (T, S) or null
    float* lse;            // (B, H, T) or null
    const long long* seed; // dropout seed (1 element) or null: no dropout
    unsigned threshold;    // keep iff the Philox word >= threshold
    float drop_scale;      // 1 / (1 - rate)
    int T, S, H, hd;
    float scale;
};

// x split into the hi and lo tiles at byte offset off
__device__ __forceinline__ void store_split(unsigned char* hi, unsigned char* lo, uint32_t off,
                                            float4 x) {
    const float2 p0 = usk::split_pair(x.x), p1 = usk::split_pair(x.y);
    const float2 p2 = usk::split_pair(x.z), p3 = usk::split_pair(x.w);
    *reinterpret_cast<float4*>(hi + off) = make_float4(p0.x, p1.x, p2.x, p3.x);
    *reinterpret_cast<float4*>(lo + off) = make_float4(p0.y, p1.y, p2.y, p3.y);
}

// The per-step pieces below are the width-64 kernel's, which
// flash_attention_f32.cu keeps inline: called there as these functions they
// cost its width-64 dropout instance 8% (0.367 -> 0.397 ms per call at the
// pretraining shape, bench_attention_forward.py --dtype fp32, an H100 at
// 700 W).

// The bias of a lane's elements of the 64-key step at s0 (row trow[i],
// keys 8 n + 2 tq and + 1), zeros outside T x S or without a bias: s is
// even and rows bias_rs (a multiple of 8, >= S) apart, so the pair lies
// inside its row
__device__ __forceinline__ void step_bias(const Args& a, float2 (&bb)[8][2], int s0,
                                          const int (&trow)[2], int tq, int h) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int s = s0 + 8 * n + 2 * tq;
            bb[n][i] = (a.bias != nullptr && trow[i] < a.T && s < a.S)
                           ? *reinterpret_cast<const float2*>(
                                 a.bias + ((size_t)h * a.T + trow[i]) * a.bias_rs + s)
                           : make_float2(0.f, 0.f);
        }
}

// The keep bits of a lane's 32 elements of the step at s0 (bit 4 n + e:
// row trow[e >> 1], key s0 + 8 n + 2 tq + (e & 1), as S's accumulator holds
// them). One Philox call gives the words of a 2 x 2 (query, key) block. A
// lane holds rows g and g + 8 and the key pairs (2 tq, 2 tq + 1) of each
// 8-key group n; the lane four apart holds rows g ^ 1 and g ^ 1 + 8, the
// other rows of the same blocks. So each lane draws the blocks of the
// groups n whose parity is its row's, keeps its own row's bits and swaps
// the other row's with its partner by one shuffle: 8 Philox calls a lane
__device__ __forceinline__ uint32_t step_keep(const Args& a, uint64_t seed, int s0,
                                              const int (&trow)[2], int g, int tq, int h, int b) {
    uint32_t own = 0, other = 0;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
        const int n = 2 * m + (g & 1);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const usk::Philox4 w = usk::philox4x32_10(
                (uint32_t)((s0 + 8 * n + 2 * tq) >> 1), (uint32_t)(trow[i] >> 1), (uint32_t)h,
                (uint32_t)b, (uint32_t)seed, (uint32_t)(seed >> 32));
            // words 0, 1: the even row's keys s, s + 1; 2, 3: the odd row's
            const uint32_t e0 = (g & 1) ? w.x[2] : w.x[0];
            const uint32_t e1 = (g & 1) ? w.x[3] : w.x[1];
            const uint32_t o0 = (g & 1) ? w.x[0] : w.x[2];
            const uint32_t o1 = (g & 1) ? w.x[1] : w.x[3];
            const int sh = 4 * n + 2 * i;
            own |= ((uint32_t)(e0 >= a.threshold) | (uint32_t)(e1 >= a.threshold) << 1) << sh;
            other |= ((uint32_t)(o0 >= a.threshold) | (uint32_t)(o1 >= a.threshold) << 1) << sh;
        }
    }
    return own | __shfl_xor_sync(0xffffffffu, other, 4);
}

// The step at s0 from its S accumulator (element 4 n + e: row trow[e >> 1],
// key s0 + 8 n + 2 tq + (e & 1)): the logits in fp32 in the plain version's
// order (x = s q.k + g b + mask, then colneg: kPadNeg on a padded key, -inf
// past S), the online softmax's max m_r and the undropped sum l_r in
// natural units with p = ex2((x - m) log2e), O's rescale alpha, and P
// (times keep / (1 - rate) with dropout) split into the A fragments of P.V:
// the fragment of a warp takes (row, k t) and (row, k t + 4) where S holds
// keys 2 t and 2 t + 1, so each 8-key group's k index is permuted (k t <->
// key 2 t, k t + 4 <-> key 2 t + 1) and V^T stores its keys in that order.
// kBias: the bias may be given (a.bias decides)
template <bool kBias, bool kDrop>
__device__ __forceinline__ void step_probs(const Args& a, float (&sacc)[32],
                                           const float2 (&bb)[8][2], const float (&gate)[2],
                                           const int (&trow)[2], const float* colneg,
                                           uint32_t keep, int s0, int tq, float (&m_r)[2],
                                           float (&l_r)[2], float (&alpha)[2],
                                           uint32_t (&ph)[8][4], uint32_t (&pl)[8][4]) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int kl = 8 * n + 2 * tq + (e & 1), s = s0 + kl, i = e >> 1, tr = trow[i];
            float x = sacc[4 * n + e] * a.scale;
            if (s < a.S && tr < a.T) {
                if (kBias && a.bias != nullptr)
                    x = __fadd_rn(x, __fmul_rn(gate[i], (e & 1) ? bb[n][i].y : bb[n][i].x));
                if (a.amask != nullptr) x = __fadd_rn(x, a.amask[(size_t)tr * a.S + s]);
            }
            x += colneg[kl];  // K's row is 0 past S
            sacc[4 * n + e] = x;
            mx[i] = fmaxf(mx[i], x);
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_r[i], mx[i]);  // finite: key s0 < S
        alpha[i] = usk::ex2((m_r[i] - m_new) * kLog2e);  // 0 on the first step
        m_r[i] = m_new;
        l_r[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
        float pe[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const float p = usk::ex2((sacc[4 * n + e] - m_r[i]) * kLog2e);
            l_r[i] += p;  // the undropped normaliser
            pe[e] = !kDrop ? p : (((keep >> (4 * n + e)) & 1u) ? p * a.drop_scale : 0.f);
        }
        usk::split_tf32(pe[0], ph[n][0], pl[n][0]);  // (g, key 2 tq)
        usk::split_tf32(pe[2], ph[n][1], pl[n][1]);  // (g + 8, key 2 tq)
        usk::split_tf32(pe[1], ph[n][2], pl[n][2]);  // (g, key 2 tq + 1)
        usk::split_tf32(pe[3], ph[n][3], pl[n][3]);  // (g + 8, key 2 tq + 1)
    }
}

// the width-80 / width-96 form's launch (flash_attention_f32_mid.cu),
// instantiated at kD = 80 and 96
template <int kD>
cudaError_t launch_mid(const Args& a, int B, cudaStream_t st);

// the width-128 form's launch (flash_attention_f32_wide.cu, hd 104-128)
cudaError_t launch_wide(const Args& a, int B, cudaStream_t st);

}  // namespace usk_attn_fwd_f32
