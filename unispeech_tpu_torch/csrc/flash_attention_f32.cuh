// Shared pieces of the fp32 attention forward (flash_attention_f32.cu, which
// holds the widths 64 and 128 and the entry, and flash_attention_f32_mid.cu,
// the widths 80 and 96, a translation unit of its own so that nvcc builds
// the two at once): constants, the kernels' arguments, the split store, the
// mid form's launch.
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

// the width-80 / width-96 form's launch (flash_attention_f32_mid.cu),
// instantiated at kD = 80 and 96
template <int kD>
cudaError_t launch_mid(const Args& a, int B, cudaStream_t st);

}  // namespace usk_attn_fwd_f32
