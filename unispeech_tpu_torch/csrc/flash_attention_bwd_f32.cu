// Fused attention backward in fp32 (merged: dq, dk, dv, dgate, dbias in one pass).
//
// Replaces unispeech_tpu/ops/pallas/flash_attention.py::_bwd_kernel
// (head-major layout, launched by _run_backward) and ::_bwd_kernel_packed
// (natural layout, launched by _run_backward_packed) at fp32, the models'
// default dtype. With q^ = q * scale (the wrapper passes q and the power-of-
// two scale, or the pre-scaled q and 1, as the forward), p = exp(s - lse)
// recomputed from the forward's inputs and lse, c = keep / (1 - rate)
// regenerated from the seed (philox.cuh, the forward's mask bit for bit) and
// delta = rowsum(dO * out):
//   dP = dO . v^T,  dS = p * (c * dP - delta)
//   dq^ = dS . k,  dk = dS^T . q^,  dv = (p * c)^T . dO
//   dgate[b,h,t] = sum_s dS * bias,  dbias[h,t,s] = sum_b gate * dS
// all in fp32, nothing rounded to a narrower type. dq^ is unscaled: the
// wrapper forms dq = dq^ * scale.
//
// Bound on the H100: operations. At the WavLM-Base pretraining shape (6 x
// 768 frames, 12 heads of 64) one call is five products of 2 B H T S hd
// FLOP, 27.2 GFLOP; as 3xTF32 (three TF32 products each, tf32.cuh) 81.5
// GFLOP of TF32, 0.165 ms at its 495 TFLOP/s peak, against ~60 MB of fp32
// inputs and outputs (18 us at 3.35 TB/s).
// Design (first form, mma.sync.m16n8k8 as the fp32 forward; wgmma takes TF32
// only with both operands K-major, which dO and q in dV and dK are not):
// one block of 8 warps per (64-key tile, head, utterance), looping over
// 64-query tiles. K and V of the tile stay in shared memory; per query tile
// q, dO, the (query, key) bias tile and the tile's (lse log2 e, delta, gate)
// rows arrive by 16-byte cp.async (rows past T or S as zeros), in row
// strides of hd + 4 (68 for the bias) floats at which every fragment read
// of S^T and dP^T is free of bank conflicts. Warp w owns keys
// [16 (w % 4), +16) and queries [32 (w / 4), +32) of the tile:
//  - S^T = K.q^T and dP^T = V.dO^T (16 keys x 32 queries, 16 accumulators
//    each), the per-element work (p, the keep bit, dS) on the accumulators;
//  - dV += (p c)^T.dO and dK += dS^T.q^ with A taken straight from those
//    accumulators by the fp32 forward's permuted k index (k t <-> query
//    2t, k t + 4 <-> query 2t + 1, dO and q rows read in the same order),
//    so each warp holds a partial dK and dV of its 16 keys over its half of
//    the queries (kD / 2 registers each) for the whole loop; the two halves
//    are added through shared memory once at the end and stored;
//  - dS^T goes to shared memory; after a barrier warp w forms dq^ of
//    queries [16 (w % 4), +16) and columns [kD/2 (w / 4), +kD/2) over the
//    tile's 64 keys and adds it into an fp32 (B, T, H, hd) buffer with one
//    fp32 atomic per element;
//  - gate * dS goes to the (H, T, S) dbias buffer by fp32 atomics from the
//    registers, and dS * bias, summed over the warp's keys by shuffles and
//    over the block's keys in shared memory, to dgate by one atomic per
//    query and block.
// Every product is split hi + lo and its three TF32 products go into a
// fresh sum that one fp32 add puts into the running sum (tf32.cuh): the
// tensor cores' own fp32 accumulation truncates, and dK and dV sum over
// all T queries. The dropout mask: one Philox call gives the words of a
// 2 x 2 (query, key) block; a lane holds keys g and g + 8 and the query
// pairs (2 tq, 2 tq + 1), the lane four apart keys g ^ 1 and g ^ 1 + 8: each
// draws the blocks of half the query groups and swaps the other key's bits
// by one shuffle. A pre-pass (rows_f32_kernel) forms delta and packs lse *
// log2 e, delta and gate per query tile (inf, 0, 1 past T), so p = 2^(x
// log2 e - lse log2 e) is one FMA and one ex2 (the padded-key logit -2^100
// stays exact under it). The order of the fp32 atomic additions (dq over
// key tiles, dbias over the batch, dgate over key tiles) varies from run
// to run: those three agree with the plain version to fp32 rounding of a
// sum of (S/64, B, S/64) terms.

#include <math.h>

#include "common.cuh"
#include "philox.cuh"
#include "tf32.cuh"

namespace {

constexpr int kBKey = 64;   // keys per block
constexpr int kBQ = 64;     // queries per step
constexpr int kThreads = 256;
constexpr int kMaxHd = 128;
constexpr int kLdB = kBKey + 4;  // floats per bias row and per dS^T row in shared memory
constexpr int kRowFloats = 3 * kBQ;  // lse log2 e, delta, gate of one query tile
constexpr float kLog2e = 1.4426950408889634f;
// a padded key's additive mask, exact under * log2 e (flash_attention_f32.cu)
constexpr float kPadNeg = -1267650600228229401496703205376.0f;  // -2^100

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
    float* dbias;          // (H, T, S) zeroed, or null
    const long long* seed; // dropout seed or null
    unsigned threshold;
    float drop_scale;
    int H, T, S, hd, n_qt;
    float scale;
};

// rows[(b*H + h), t / 64, :, t % 64] = (lse * log2 e, delta = sum_d dO * out, gate)
// for t < n_qt * 64, (inf, 0, 1) past T: 8 lanes per (b, h, t), each over
// the 4-column slices part, part + 8, ... below hd
__global__ void __launch_bounds__(256) rows_f32_kernel(const Args a, int total) {
    const int r = blockIdx.x * 32 + threadIdx.x / 8;
    const int part = threadIdx.x % 8;
    const int tp = a.n_qt * kBQ;
    const int bh = r / tp, t = r % tp;
    const int b = bh / a.H, h = bh % a.H;
    const bool ok = r < total && t < a.T;
    float acc = 0.f;
    if (ok) {
        for (int c = part * 4; c < a.hd; c += 32) {
            const float4 o = *reinterpret_cast<const float4*>(
                a.out + b * a.o_bs + t * a.o_rs + h * a.hd + c);
            const float4 d = *reinterpret_cast<const float4*>(
                a.dout + b * a.do_bs + t * a.do_rs + h * a.hd + c);
            acc = fmaf(d.x, o.x, acc);
            acc = fmaf(d.y, o.y, acc);
            acc = fmaf(d.z, o.z, acc);
            acc = fmaf(d.w, o.w, acc);
        }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    acc += __shfl_xor_sync(0xffffffffu, acc, 4);
    if (r < total && part == 0) {
        float* dst = a.rows + ((size_t)bh * a.n_qt + t / kBQ) * kRowFloats + t % kBQ;
        const size_t src = (size_t)bh * a.T + t;
        dst[0] = ok ? a.lse[src] * kLog2e : INFINITY;  // p = 0 on rows past T
        dst[kBQ] = ok ? acc : 0.f;
        dst[2 * kBQ] = (ok && a.gate != nullptr) ? a.gate[src] : 1.f;
    }
}

// kD: the padded head dim (64 or 128, the dK / dV / dq^ accumulators'
// registers); kBias: a bias tile per query tile (and dbias, dgate with a
// gate); kDrop: dropout
template <int kD, bool kBias, bool kDrop>
__global__ void __launch_bounds__(kThreads) flash_bwd_f32_kernel(const Args a) {
    extern __shared__ float4 attn_bwd_f32_smem[];
    const int hd = a.hd, ld = hd + 4, n4 = hd / 4;
    float* Ks = reinterpret_cast<float*>(attn_bwd_f32_smem);
    float* Vs = Ks + kBKey * ld;
    float* Qs = Vs + kBKey * ld;
    float* Ds = Qs + kBQ * ld;        // dO
    float* Bs = Ds + kBQ * ld;        // bias [query][key]
    float* dSs = Bs + kBQ * kLdB;     // dS^T [key][query]
    float* rows = dSs + kBKey * kLdB; // lse log2 e, delta, gate
    float* colneg = rows + kRowFloats;  // per key: 0, kPadNeg (padded) or -inf (past S)
    float* dgs = colneg + kBKey;        // dgate of the tile's queries

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, tq = lane & 3;
    const int s0 = blockIdx.x * kBKey, h = blockIdx.y, b = blockIdx.z;
    const int T = a.T, S = a.S;
    const int kg = warp & 3, qh = warp >> 2;  // S^T / dK / dV: keys 16 kg, queries 32 qh
    const uint64_t seed = kDrop ? (uint64_t)*a.seed : 0;

    // rows [r0, r0 + 64) of head h of a (B, rows, H, hd) tensor
    auto load_tile = [&](float* dst, const float* src, long long bs, long long rs, int r0,
                         int nrows) {
        for (int i = tid; i < 64 * n4; i += kThreads) {
            const int r = i / n4, c = i % n4;
            const bool ok = r0 + r < nrows;
            const float* p = src + b * bs + (ok ? r0 + r : 0) * rs + (long long)h * hd + 4 * c;
            usk::cp_async16(dst + r * ld + 4 * c, p, ok);
        }
    };
    load_tile(Ks, a.k, a.k_bs, a.k_rs, s0, S);
    load_tile(Vs, a.v, a.v_bs, a.v_rs, s0, S);
    usk::cp_async_commit();
    if (tid < kBKey) {
        const int s = s0 + tid;
        colneg[tid] = s >= S ? -INFINITY
                             : ((a.kpm != nullptr && a.kpm[(size_t)b * S + s] != 0) ? kPadNeg : 0.f);
    }

    // this lane's keys (tile-local) of S^T: 16 kg + g and + 8
    const int kl0 = 16 * kg + g;
    float dk[kD / 8][4], dv[kD / 8][4];
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

    const float* rows_src = a.rows + (size_t)(b * a.H + h) * a.n_qt * kRowFloats;
    for (int qt = 0; qt < a.n_qt; ++qt) {
        const int t0 = qt * kBQ;
        __syncthreads();  // the previous tile's q, dO, bias, rows and dS^T are consumed
        load_tile(Qs, a.q, a.q_bs, a.q_rs, t0, T);
        load_tile(Ds, a.dout, a.do_bs, a.do_rs, t0, T);
        if (kBias) {
            for (int i = tid; i < kBQ * (kBKey / 4); i += kThreads) {
                const int r = i / (kBKey / 4), c = 4 * (i % (kBKey / 4));
                // a chunk that starts below S lies inside its row (rows are a
                // multiple of 8 floats, at least S, apart)
                const bool ok = t0 + r < T && s0 + c < S;
                const float* p = a.bias + ((size_t)h * T + (ok ? t0 + r : 0)) * a.bias_rs +
                                 (ok ? s0 + c : 0);
                usk::cp_async16(Bs + r * kLdB + c, p, ok);
            }
        }
        if (tid < kRowFloats / 4)
            usk::cp_async16(rows + 4 * tid, rows_src + (size_t)qt * kRowFloats + 4 * tid, true);
        usk::cp_async_commit();
        if (kBias && tid < kBQ) dgs[tid] = 0.f;
        usk::cp_async_wait<0>();
        __syncthreads();

        // S^T = K.q^T and dP^T = V.dO^T: keys kl0 (+8) x queries 32 qh + 8 n
        // + 2 tq (+1); element e of st[n]: key kl0 + 8 (e >> 1), query
        // 32 qh + 8 n + 2 tq + (e & 1)
        float st[4][4], dpt[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
        for (int d0 = 0; d0 < kD; d0 += 8) {
            if (d0 >= hd) break;
            const float* kp = Ks + kl0 * ld + d0 + tq;
            const float* vp = Vs + kl0 * ld + d0 + tq;
            uint32_t kh[4], kl[4], vh[4], vl[4];
            usk::split_tf32(kp[0], kh[0], kl[0]);
            usk::split_tf32(kp[8 * ld], kh[1], kl[1]);
            usk::split_tf32(kp[4], kh[2], kl[2]);
            usk::split_tf32(kp[8 * ld + 4], kh[3], kl[3]);
            usk::split_tf32(vp[0], vh[0], vl[0]);
            usk::split_tf32(vp[8 * ld], vh[1], vl[1]);
            usk::split_tf32(vp[4], vh[2], vl[2]);
            usk::split_tf32(vp[8 * ld + 4], vh[3], vl[3]);
#pragma unroll
            for (int n = 0; n < 4; ++n) {
                const int qr = 32 * qh + 8 * n + g;
                const float* qp = Qs + qr * ld + d0 + tq;
                const float* dp = Ds + qr * ld + d0 + tq;
                uint32_t bh0, bl0, bh1, bl1;
                usk::split_tf32(qp[0], bh0, bl0);
                usk::split_tf32(qp[4], bh1, bl1);
                usk::mma_3xtf32(st[n], kh, kl, bh0, bh1, bl0, bl1);
                usk::split_tf32(dp[0], bh0, bl0);
                usk::split_tf32(dp[4], bh1, bl1);
                usk::mma_3xtf32(dpt[n], vh, vl, bh0, bh1, bl0, bl1);
            }
        }

        // the keep bits: bit 4 n + e of keep is element e of st[n]
        uint32_t keep = 0xffffffffu;
        if (kDrop) {
            uint32_t own = 0, other = 0;
#pragma unroll
            for (int m = 0; m < 2; ++m) {
                const int n = 2 * m + (g & 1);
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const int s = s0 + kl0 + 8 * i, t = t0 + 32 * qh + 8 * n + 2 * tq;
                    const usk::Philox4 w = usk::philox4x32_10(
                        (uint32_t)(s >> 1), (uint32_t)(t >> 1), (uint32_t)h, (uint32_t)b,
                        (uint32_t)seed, (uint32_t)(seed >> 32));
                    // word (s & 1) | (t & 1) << 1: this key's (t, t + 1) and the other key's
                    const uint32_t e0 = (g & 1) ? w.x[1] : w.x[0], e1 = (g & 1) ? w.x[3] : w.x[2];
                    const uint32_t o0 = (g & 1) ? w.x[0] : w.x[1], o1 = (g & 1) ? w.x[2] : w.x[3];
                    const int sh = 4 * n + 2 * i;
                    own |= ((uint32_t)(e0 >= a.threshold) | (uint32_t)(e1 >= a.threshold) << 1) << sh;
                    other |= ((uint32_t)(o0 >= a.threshold) | (uint32_t)(o1 >= a.threshold) << 1)
                             << sh;
                }
            }
            keep = own | __shfl_xor_sync(0xffffffffu, other, 4);
        }

        // p, p c and dS per element; st becomes p c, dpt dS
        float dg[4][2];  // dS * bias of (query pair n, query + c), summed over this lane's keys
#pragma unroll
        for (int n = 0; n < 4; ++n) {
            dg[n][0] = dg[n][1] = 0.f;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int i = e >> 1, kl = kl0 + 8 * i, s = s0 + kl;
                const int ql = 32 * qh + 8 * n + 2 * tq + (e & 1), t = t0 + ql;
                float x = st[n][e] * a.scale;
                float bv = 0.f;
                if (kBias) {
                    bv = Bs[ql * kLdB + kl];
                    x = __fadd_rn(x, __fmul_rn(rows[2 * kBQ + ql], bv));
                }
                if (a.amask != nullptr && t < T && s < S) x = __fadd_rn(x, a.amask[(size_t)t * S + s]);
                x += colneg[kl];
                const float p = usk::ex2(fmaf(x, kLog2e, -rows[ql]));
                const float c = kDrop ? (((keep >> (4 * n + e)) & 1u) ? a.drop_scale : 0.f) : 1.f;
                const float ds = kDrop ? __fmul_rn(p, __fsub_rn(__fmul_rn(c, dpt[n][e]), rows[kBQ + ql]))
                                       : __fmul_rn(p, __fsub_rn(dpt[n][e], rows[kBQ + ql]));
                st[n][e] = kDrop ? __fmul_rn(p, c) : p;
                dpt[n][e] = ds;
                if (kBias) {
                    dg[n][e & 1] = fmaf(ds, bv, dg[n][e & 1]);
                    if (a.dbias != nullptr && t < T && s < S)
                        atomicAdd(a.dbias + ((size_t)h * T + t) * S + s, __fmul_rn(rows[2 * kBQ + ql], ds));
                }
                dSs[kl * kLdB + ql] = ds;
            }
        }
        if (kBias && a.dgate != nullptr) {
            // over the 8 lanes of a column (g) of this warp, then the block's 4 key groups
#pragma unroll
            for (int n = 0; n < 4; ++n)
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    float v = dg[n][c];
                    v += __shfl_xor_sync(0xffffffffu, v, 4);
                    v += __shfl_xor_sync(0xffffffffu, v, 8);
                    v += __shfl_xor_sync(0xffffffffu, v, 16);
                    if (g == 0) atomicAdd(dgs + 32 * qh + 8 * n + 2 * tq + c, v);
                }
        }

        // dV += (p c)^T.dO and dK += dS^T.q over this warp's 32 queries, 8 at
        // a time, the k index permuted (k tq <-> query 2 tq, k tq + 4 <-> 2 tq + 1)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            uint32_t ph[4], pl[4], sh_[4], sl[4];
            usk::split_tf32(st[j][0], ph[0], pl[0]);
            usk::split_tf32(st[j][2], ph[1], pl[1]);
            usk::split_tf32(st[j][1], ph[2], pl[2]);
            usk::split_tf32(st[j][3], ph[3], pl[3]);
            usk::split_tf32(dpt[j][0], sh_[0], sl[0]);
            usk::split_tf32(dpt[j][2], sh_[1], sl[1]);
            usk::split_tf32(dpt[j][1], sh_[2], sl[2]);
            usk::split_tf32(dpt[j][3], sh_[3], sl[3]);
            const int qr = 32 * qh + 8 * j + 2 * tq;
            const float* dop = Ds + qr * ld + g;
            const float* qp = Qs + qr * ld + g;
#pragma unroll
            for (int n = 0; n < kD / 8; ++n) {
                if (8 * n >= hd) break;
                uint32_t bh0, bl0, bh1, bl1;
                usk::split_tf32(dop[8 * n], bh0, bl0);
                usk::split_tf32(dop[ld + 8 * n], bh1, bl1);
                usk::mma_3xtf32(dv[n], ph, pl, bh0, bh1, bl0, bl1);
                usk::split_tf32(qp[8 * n], bh0, bl0);
                usk::split_tf32(qp[ld + 8 * n], bh1, bl1);
                usk::mma_3xtf32(dk[n], sh_, sl, bh0, bh1, bl0, bl1);
            }
        }
        __syncthreads();  // dS^T and the dgate sums are complete

        if (kBias && a.dgate != nullptr && tid < kBQ && t0 + tid < T)
            atomicAdd(a.dgate + ((size_t)b * a.H + h) * T + t0 + tid, dgs[tid]);

        // dq^ = dS.K: queries 16 (w % 4) + g (+8), columns kD/2 (w / 4) + 8 n
        // + 2 tq (+1), over the tile's 64 keys
        {
            constexpr int kN = kD / 16;  // 8-column groups per warp
            const int qg = warp & 3, c0 = (kD / 2) * (warp >> 2);
            if (c0 < hd) {
                float acc[kN][4];
#pragma unroll
                for (int n = 0; n < kN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
                for (int kk = 0; kk < kBKey; kk += 8) {
                    const float* ap = dSs + (kk + tq) * kLdB + 16 * qg + g;
                    uint32_t ah[4], al[4];
                    usk::split_tf32(ap[0], ah[0], al[0]);
                    usk::split_tf32(ap[8], ah[1], al[1]);
                    usk::split_tf32(ap[4 * kLdB], ah[2], al[2]);
                    usk::split_tf32(ap[4 * kLdB + 8], ah[3], al[3]);
                    const float* kp = Ks + (kk + tq) * ld + c0 + g;
#pragma unroll
                    for (int n = 0; n < kN; ++n) {
                        if (c0 + 8 * n >= hd) break;
                        uint32_t bh0, bl0, bh1, bl1;
                        usk::split_tf32(kp[8 * n], bh0, bl0);
                        usk::split_tf32(kp[4 * ld + 8 * n], bh1, bl1);
                        usk::mma_3xtf32(acc[n], ah, al, bh0, bh1, bl0, bl1);
                    }
                }
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const int t = t0 + 16 * qg + g + 8 * i;
                    if (t >= T) continue;
                    float* dst = a.dq + (((size_t)b * T + t) * a.H + h) * hd + c0 + 2 * tq;
#pragma unroll
                    for (int n = 0; n < kN; ++n) {
                        if (c0 + 8 * n >= hd) break;
                        atomicAdd(dst + 8 * n, acc[n][2 * i]);
                        atomicAdd(dst + 8 * n + 1, acc[n][2 * i + 1]);
                    }
                }
            }
        }
    }

    // the two query halves' dK and dV: the second half's through shared memory
    __syncthreads();
    float* sk = Qs;  // [key][ld], then dV at Ds
    float* sv = Ds;
    if (qh == 1) {
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
            if (8 * n >= hd) break;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int off = (kl0 + 8 * i) * ld + 8 * n + 2 * tq;
                *reinterpret_cast<float2*>(sk + off) = make_float2(dk[n][2 * i], dk[n][2 * i + 1]);
                *reinterpret_cast<float2*>(sv + off) = make_float2(dv[n][2 * i], dv[n][2 * i + 1]);
            }
        }
    }
    __syncthreads();
    if (qh == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int s = s0 + kl0 + 8 * i;
            if (s >= S) continue;
            const size_t row = (((size_t)b * S + s) * a.H + h) * hd + 2 * tq;
            float* dkp = a.dk + row;
            float* dvp = a.dv + row;
#pragma unroll
            for (int n = 0; n < kD / 8; ++n) {
                if (8 * n >= hd) break;
                const int off = (kl0 + 8 * i) * ld + 8 * n + 2 * tq;
                const float2 k2 = *reinterpret_cast<const float2*>(sk + off);
                const float2 v2 = *reinterpret_cast<const float2*>(sv + off);
                *reinterpret_cast<float2*>(dkp + 8 * n) =
                    make_float2((dk[n][2 * i] + k2.x) * a.scale, (dk[n][2 * i + 1] + k2.y) * a.scale);
                *reinterpret_cast<float2*>(dvp + 8 * n) =
                    make_float2(dv[n][2 * i] + v2.x, dv[n][2 * i + 1] + v2.y);
            }
        }
    }
}

template <int kD, bool kBias, bool kDrop>
cudaError_t launch_kernel(const Args& a, dim3 grid, cudaStream_t st) {
    auto kernel = flash_bwd_f32_kernel<kD, kBias, kDrop>;
    const int smem = ((kBKey + kBQ) * 2 * (a.hd + 4) + 2 * kBQ * kLdB + kRowFloats + kBKey + kBQ) *
                     (int)sizeof(float);
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, st>>>(a);
    return cudaGetLastError();
}

template <int kD>
cudaError_t launch_width(const Args& a, dim3 grid, cudaStream_t st) {
    const bool drop = a.seed != nullptr;
    if (a.bias != nullptr)
        return drop ? launch_kernel<kD, true, true>(a, grid, st)
                    : launch_kernel<kD, true, false>(a, grid, st);
    return drop ? launch_kernel<kD, false, true>(a, grid, st)
                : launch_kernel<kD, false, false>(a, grid, st);
}

}  // namespace

// q, out, dout (B, T, H, hd) and k, v (B, S, H, hd) fp32 by (batch, row)
// strides in elements, rows of H hd contiguous floats, 16-byte aligned; lse (B, H, T) fp32; bias (H, T,
// S) fp32 with rows bias_rs (a multiple of 8, >= S) apart, or null; gate
// (B, H, T) fp32 or null; kpm (B, S) bool or null; amask (T, S) fp32 or
// null; dk, dv (B, S, H, hd) contiguous fp32; dq (B, T, H, hd), dgate (B,
// H, T) and dbias (H, T, S) zeroed contiguous fp32
// buffers (dgate, dbias null without gate / bias); rows (B * H,
// ceil(T/64), 3, 64) fp32 scratch; seed a 1-element int64 or null; hd a
// multiple of 8 up to 128
extern "C" int usk_flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* out, const void* dout,
    const void* lse, long long q_bs, long long q_rs, long long k_bs, long long k_rs,
    long long v_bs, long long v_rs, long long o_bs, long long o_rs, long long do_bs,
    long long do_rs, const void* bias, long long bias_rs, const void* gate, const void* kpm,
    const void* amask, void* dq, void* dk, void* dv, void* dgate, void* dbias, int B, int T,
    int S, int H, int hd, float scale, void* rows, unsigned threshold, float drop_scale,
    const void* seed, void* stream) {
    if (hd < 8 || hd > kMaxHd || hd % 8 != 0 || B > 65535 || H > 65535)
        return (int)cudaErrorInvalidValue;
    Args a;
    a.q = (const float*)q;
    a.k = (const float*)k;
    a.v = (const float*)v;
    a.out = (const float*)out;
    a.dout = (const float*)dout;
    a.lse = (const float*)lse;
    a.q_bs = q_bs; a.q_rs = q_rs; a.k_bs = k_bs; a.k_rs = k_rs; a.v_bs = v_bs; a.v_rs = v_rs;
    a.o_bs = o_bs; a.o_rs = o_rs; a.do_bs = do_bs; a.do_rs = do_rs;
    a.bias = (const float*)bias;
    a.bias_rs = bias_rs;
    a.gate = (const float*)gate;
    a.kpm = (const uint8_t*)kpm;
    a.amask = (const float*)amask;
    a.rows = (float*)rows;
    a.dq = (float*)dq;
    a.dk = (float*)dk;
    a.dv = (float*)dv;
    a.dgate = (float*)dgate;
    a.dbias = (float*)dbias;
    a.seed = (const long long*)seed;
    a.threshold = threshold;
    a.drop_scale = drop_scale;
    a.H = H; a.T = T; a.S = S; a.hd = hd;
    a.n_qt = (T + kBQ - 1) / kBQ;
    a.scale = scale;
    cudaStream_t s = (cudaStream_t)stream;
    const int total = B * H * a.n_qt * kBQ;
    rows_f32_kernel<<<(total + 31) / 32, 256, 0, s>>>(a, total);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((S + kBKey - 1) / kBKey, H, B);
    if (hd <= 64) return (int)launch_width<64>(a, grid, s);
    return (int)launch_width<128>(a, grid, s);
}
