// Shared pieces of the fp32 attention backward (flash_attention_bwd_f32.cu,
// which holds the widths 64 and 128 and the entry, and
// flash_attention_bwd_f32_mid.cu, the widths 80 and 96, a translation unit
// of its own so that nvcc builds the two at once): tiles and constants, the
// kernels' arguments, and the per-step pieces both wgmma forms run.
#pragma once

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"
#include "philox.cuh"
#include "tf32.cuh"

namespace usk_attn_bwd_f32 {

constexpr int kBKey = 64;   // keys per block
constexpr int kBQ = 64;     // queries per rows tile (and per step of the wide kernel)
constexpr int kMaxHd = 128;
constexpr int kMidMaxHd = 96;  // the widest head of the wgmma forms
constexpr int kLdB = kBKey + 4;  // floats per bias row and per dS^T row in shared memory (wide)
constexpr int kRowFloats = 3 * kBQ;  // lse log2 e, delta, gate of one query tile
constexpr float kLog2e = 1.4426950408889634f;
// a padded key's additive mask, exact under * log2 e (flash_attention_f32.cu)
constexpr float kPadNeg = -1267650600228229401496703205376.0f;  // -2^100

// the width-64 kernel: one warpgroup, 32-query steps; shared memory in
// bytes from a 1024-byte aligned base: the staging boxes (dq^ 2, gate * dS
// 2), then the split tiles (hi, lo each) in the 128-byte swizzle: K, V
// [key][column], K^T [column][key], q, dO [query][column], q^T, dO^T
// [column][query], dS [query][key]; the next step's q and dO in fp32, the
// rows of two steps, the key mask, the step's dgate sums per warp, the step's bias
constexpr int kQS = 32;                      // queries per step
constexpr int kThreads64 = 128;
constexpr int kThreadsWide = 256;
constexpr uint32_t kBox = 32 * 32 * 4;       // 32 x 32 fp32, 128-byte swizzled
constexpr uint32_t kTile64 = 64 * 64 * 4;    // a 64-row split tile (hi or lo)
constexpr uint32_t kTile32 = kQS * 64 * 4;   // a 32-row one, or 64 rows of 32
constexpr uint32_t kOffDqBox = 0;
constexpr uint32_t kOffGdBox = 2 * kBox;
constexpr uint32_t kOffK = 4 * kBox;
constexpr uint32_t kOffV = kOffK + 2 * kTile64;
constexpr uint32_t kOffKt = kOffV + 2 * kTile64;
constexpr uint32_t kOffQ = kOffKt + 2 * kTile64;
constexpr uint32_t kOffD = kOffQ + 2 * kTile32;
constexpr uint32_t kOffQt = kOffD + 2 * kTile32;
constexpr uint32_t kOffDt = kOffQt + 2 * kTile32;
constexpr uint32_t kOffS = kOffDt + 2 * kTile32;
constexpr uint32_t kOffStage = kOffS + 2 * kTile32;
constexpr uint32_t kOffRows = kOffStage + 2 * kQS * 64 * 4;
constexpr uint32_t kOffCol = kOffRows + 2 * 3 * kQS * 4;
constexpr uint32_t kOffDg = kOffCol + kBKey * 4;
constexpr int kLdBias = kBKey + 4;           // a bias tile row: conflict-free reads below
constexpr uint32_t kOffBias = kOffDg + 4 * kQS * 4;  // the step's bias [query][key], fp32
constexpr int kSmem64 = (int)(kOffBias + kQS * kLdBias * 4) + 1024;

struct Maps {
    CUtensorMap dq;     // fp32 (B, T, H, hd): dims {hd, H, T, B}, boxes of 32 x 32 rows
    CUtensorMap dbias;  // fp32 (H, T, S64): dims {S64, T, H}, boxes of 32 x 32 rows
};

struct Args {
    const float *q, *k, *v, *out, *dout;
    const float* lse;  // (B, H, T)
    long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, do_bs, do_rs;  // elements
    const float* bias;  // (H, T, S) rows bias_rs apart, or null
    long long bias_rs;
    const float* gate;     // (B, H, T) or null (gate 1 with bias)
    const uint8_t* kpm;    // (B, S) 1 = padded key, or null
    const float* amask;    // (T, S) or null
    float* rows;           // (B * H, n_qt, 3, 64): lse log2 e, delta, gate per query tile
    float* dq;             // (B, T, H, hd) zeroed: dq^ = dS . k
    float *dk, *dv;        // (B, S, H, hd) contiguous
    float* dgate;          // (B, H, T) zeroed, or null
    float* dbias;          // (H, T, dbias_rs) zeroed, or null
    long long dbias_rs;    // S rounded up to 64
    const long long* seed; // dropout seed or null
    unsigned threshold;
    float drop_scale;
    int H, T, S, hd, n_qt;
    float scale;
};

// x split into the hi and lo tiles at byte offset off (4 and 2 values)
__device__ __forceinline__ void store_split4(unsigned char* hi, unsigned char* lo, uint32_t off,
                                             float4 x) {
    const float2 p0 = usk::split_pair(x.x), p1 = usk::split_pair(x.y);
    const float2 p2 = usk::split_pair(x.z), p3 = usk::split_pair(x.w);
    *reinterpret_cast<float4*>(hi + off) = make_float4(p0.x, p1.x, p2.x, p3.x);
    *reinterpret_cast<float4*>(lo + off) = make_float4(p0.y, p1.y, p2.y, p3.y);
}

__device__ __forceinline__ void store_split2(unsigned char* hi, unsigned char* lo, uint32_t off,
                                             float x0, float x1) {
    const float2 p0 = usk::split_pair(x0), p1 = usk::split_pair(x1);
    *reinterpret_cast<float2*>(hi + off) = make_float2(p0.x, p1.x);
    *reinterpret_cast<float2*>(lo + off) = make_float2(p0.y, p1.y);
}

// The keep bits of a lane's 16 elements of a 64-key x 32-query step (bit
// 4 n + e: key s + 8 (e >> 1), query t0 + 8 n + 2 tq + (e & 1), as the
// accumulators of S^T): one Philox call gives the words of a 2 x 2 (query,
// key) block; a lane holds keys g and g + 8 and the query pair (2 tq, 2 tq
// + 1) of each 8-query group, the lane four apart keys g ^ 1 and g ^ 1 + 8:
// each draws the blocks of the groups whose parity is its key's and swaps
// the other key's bits by one shuffle
__device__ __forceinline__ uint32_t step_keep(const Args& a, uint64_t seed, int s, int t0, int g,
                                              int tq, int h, int b) {
    uint32_t own = 0, other = 0;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
        const int n = 2 * m + (g & 1);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int si = s + 8 * i, t = t0 + 8 * n + 2 * tq;
            const usk::Philox4 w = usk::philox4x32_10(
                (uint32_t)(si >> 1), (uint32_t)(t >> 1), (uint32_t)h, (uint32_t)b,
                (uint32_t)seed, (uint32_t)(seed >> 32));
            // word (s & 1) | (t & 1) << 1: this key's (t, t + 1) and the other key's
            const uint32_t e0 = (g & 1) ? w.x[1] : w.x[0];
            const uint32_t e1 = (g & 1) ? w.x[3] : w.x[2];
            const uint32_t o0 = (g & 1) ? w.x[0] : w.x[1];
            const uint32_t o1 = (g & 1) ? w.x[2] : w.x[3];
            const int sh = 4 * n + 2 * i;
            own |= ((uint32_t)(e0 >= a.threshold) | (uint32_t)(e1 >= a.threshold) << 1) << sh;
            other |= ((uint32_t)(o0 >= a.threshold) | (uint32_t)(o1 >= a.threshold) << 1) << sh;
        }
    }
    return own | __shfl_xor_sync(0xffffffffu, other, 4);
}

// p, p c and dS of a step's S^T and dP^T accumulators (st becomes p c, dpt
// dS), and dS * bias summed over the lane's keys into dg; rw: the step's
// lse log2 e, delta and gate rows; bias_s: its bias tile [query][key]
template <bool kBias, bool kDrop>
__device__ __forceinline__ void step_probs(const Args& a, float (&st)[16], float (&dpt)[16],
                                           float (&dg)[4][2], uint32_t keep, const float* rw,
                                           const float* bias_s, const float* colneg, int kl0,
                                           int tq, int s0, int t0) {
    const int T = a.T, S = a.S;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
        dg[n][0] = dg[n][1] = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int kl = kl0 + 8 * (e >> 1), s = s0 + kl;
            const int ql = 8 * n + 2 * tq + (e & 1), t = t0 + ql;
            float x = st[4 * n + e] * a.scale;
            const float bv = kBias ? bias_s[ql * kLdBias + kl] : 0.f;
            if (kBias) x = __fadd_rn(x, __fmul_rn(rw[2 * kQS + ql], bv));
            if (a.amask != nullptr && t < T && s < S) x = __fadd_rn(x, a.amask[(size_t)t * S + s]);
            x += colneg[kl];
            const float p = usk::ex2(fmaf(x, kLog2e, -rw[ql]));
            const float c = kDrop ? (((keep >> (4 * n + e)) & 1u) ? a.drop_scale : 0.f) : 1.f;
            const float ds = kDrop ? __fmul_rn(p, __fsub_rn(__fmul_rn(c, dpt[4 * n + e]), rw[kQS + ql]))
                                   : __fmul_rn(p, __fsub_rn(dpt[4 * n + e], rw[kQS + ql]));
            st[4 * n + e] = kDrop ? __fmul_rn(p, c) : p;
            dpt[4 * n + e] = ds;
            if (kBias) dg[n][e & 1] = fmaf(ds, bv, dg[n][e & 1]);
        }
    }
}

// the width-80 / width-96 form's launch (flash_attention_bwd_f32_mid.cu),
// instantiated at kD = 80 and 96
template <int kD>
cudaError_t launch_mid_any(const Maps& maps, const Args& a, dim3 grid, cudaStream_t st);

}  // namespace usk_attn_bwd_f32
