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
// Design at kD = 64 (the padded head dim of every fp32 model of the family),
// the Hopper redesign of the first form (mma.sync with every fragment split
// in every warp, dq^ and dbias by ~85 M scalar fp32 atomics per Base call,
// 11% of the bound; an mma.sync form with tiles split once and tile
// reductions ran no faster: TF32 mma.sync itself was the ceiling): one
// warpgroup per (64-key tile, head, utterance), looping over 32-query
// steps, 219 KB of shared memory, the five products on wgmma (TF32, fp32
// accumulators in registers), whose operands in shared memory must all be
// K-major (128-byte swizzle, tf32.cuh):
//  - split once: K and V are split into TF32 hi + lo once per block as they
//    are stored (K and V [key][column], and K^T [column][key]), q and dO
//    once per step ([query][column], and q^T, dO^T [column][query] with the
//    queries of each group of 8 in P's k order); a step's q, dO and bias
//    tile arrive by cp.async a step ahead;
//  - S^T = K.q^T and dP^T = V.dO^T (64 keys x 32 queries, m64n32k8, both
//    operands from shared memory), three products per 8 columns (lo.hi,
//    hi.lo, hi.hi) summed by the tensor cores over kD (adding each 8
//    columns' sum by an fp32 add, as the forward does, waited on the tensor
//    cores 8 times a step and spilled registers); the keep bits while they
//    run;
//  - the per-element work (p, the keep bit, dS, dgate's dS * bias) on the
//    accumulators; the stores of dS and gate * dS and dgate's shuffles wait
//    behind dV's products (one warpgroup: work not behind a product is the
//    step's critical path); dV += (p c)^T.dO and dK += dS^T.q^ (m64n64k8) with A
//    from those registers, split in place, by a permuted k index (k t <->
//    query 2t, k t + 4 <-> query 2t + 1, the order q^T and dO^T are stored
//    in), each step's twelve products into a fresh accumulator that one fp32
//    add puts into dK or dV, which stay in registers for the whole loop (dK
//    and dV sum over all T queries);
//  - dS goes to shared memory as its split pairs ([query][key]);
//    dq^T = K^T.dS^T (m64n32k8, columns x queries) from K^T and that tile;
//  - no scalar atomics for the cross-block sums: dq^ and gate * dS of a step
//    are written to 128-byte-swizzled staging boxes (32 x 32 fp32) and added
//    into the fp32 dq^ (B, T, H, hd) and dbias (H, T, S64) buffers by the
//    TMA unit's reductions (cp.reduce.async.bulk.tensor, four per step, as
//    the bf16 kernel adds them), rows past T and columns past hd clipped by
//    the maps; dS * bias, summed over the warp's keys by shuffles and over
//    the block's 4 warps through shared memory, goes to dgate by one atomic
//    per query and block.
// The dropout mask: one Philox call gives the words of a 2 x 2 (query, key)
// block; a lane holds keys g and g + 8 and the query pair (2 tq, 2 tq + 1)
// of each 8-query group, the lane four apart keys g ^ 1 and g ^ 1 + 8: each
// draws the blocks of the groups whose parity is its key's and swaps the
// other key's bits by one shuffle. A pre-pass (rows_f32_kernel) forms delta
// and packs lse * log2 e, delta and gate per 64-query tile (inf, 0, 1 past
// T), so p = 2^(x log2 e - lse log2 e) is one FMA and one ex2 (the
// padded-key logit -2^100 stays exact under it). The order of the fp32
// reductions (dq over key tiles, dbias over the batch, dgate over key tiles)
// varies from run to run: those three agree with the plain version to fp32
// rounding of a sum of (S/64, B, S/64) terms.
// At kD = 128 (hd 72-128, which no fp32 model of the family has) the split
// K, V and K^T alone would take 192 KB of shared memory, so the first form
// runs there (flash_bwd_f32_wide_kernel: fp32 tiles split at each fragment
// read on mma.sync, 64-query steps, atomics for dq^ and dbias into the same
// buffers).

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"
#include "philox.cuh"
#include "tf32.cuh"

namespace {

constexpr int kBKey = 64;   // keys per block
constexpr int kBQ = 64;     // queries per rows tile (and per step of the wide kernel)
constexpr int kMaxHd = 128;
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

// kBias: a bias per (query, key), and dbias (dgate with a gate); kDrop: dropout
template <bool kBias, bool kDrop>
__global__ void __launch_bounds__(kThreads64, 1)
    flash_bwd_f32_kernel(const __grid_constant__ Maps maps, const Args a) {
    extern __shared__ unsigned char attn_bwd_f32_raw[];
    unsigned char* sm = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(attn_bwd_f32_raw) + 1023) & ~uintptr_t(1023));
    unsigned char* dq_box = sm + kOffDqBox;
    unsigned char* gd_box = sm + kOffGdBox;
    unsigned char *Kh = sm + kOffK, *Kl = Kh + kTile64;
    unsigned char *Vh = sm + kOffV, *Vl = Vh + kTile64;
    unsigned char *Kth = sm + kOffKt, *Ktl = Kth + kTile64;
    unsigned char *Qh = sm + kOffQ, *Ql = Qh + kTile32;
    unsigned char *Dh = sm + kOffD, *Dl = Dh + kTile32;
    unsigned char *Qth = sm + kOffQt, *Qtl = Qth + kTile32;
    unsigned char *Dth = sm + kOffDt, *Dtl = Dth + kTile32;
    unsigned char *Sh = sm + kOffS, *Sl = Sh + kTile32;
    float* stq = reinterpret_cast<float*>(sm + kOffStage);  // the next step's q, fp32 [32][64]
    float* stdo = stq + kQS * 64;                            // and dO
    float* rows = reinterpret_cast<float*>(sm + kOffRows);   // [2][lse log2 e, delta, gate][32]
    float* colneg = reinterpret_cast<float*>(sm + kOffCol);
    float* dgs = reinterpret_cast<float*>(sm + kOffDg);  // [warp][query]
    float* bias_s = reinterpret_cast<float*>(sm + kOffBias);
    // the tiles' wgmma descriptors: one for the base, and a tile or k step
    // adds its byte offset / 16 (the start address field), so no step
    // builds one
    const uint64_t d0 = usk::desc_sw128(sm, 16, 1024);
    const uint64_t dKh = d0 + (kOffK >> 4), dKl = dKh + (kTile64 >> 4);
    const uint64_t dVh = d0 + (kOffV >> 4), dVl = dVh + (kTile64 >> 4);
    const uint64_t dKth = d0 + (kOffKt >> 4), dKtl = dKth + (kTile64 >> 4);
    const uint64_t dQh = d0 + (kOffQ >> 4), dQl = dQh + (kTile32 >> 4);
    const uint64_t dDh = d0 + (kOffD >> 4), dDl = dDh + (kTile32 >> 4);
    const uint64_t dQth = d0 + (kOffQt >> 4), dQtl = dQth + (kTile32 >> 4);
    const uint64_t dDth = d0 + (kOffDt >> 4), dDtl = dDth + (kTile32 >> 4);
    const uint64_t dSh = d0 + (kOffS >> 4), dSl = dSh + (kTile32 >> 4);

    const int hd = a.hd;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, tq = lane & 3;
    const int s0 = blockIdx.x * kBKey, h = blockIdx.y, b = blockIdx.z;
    const int T = a.T, S = a.S;
    const int kl0 = 16 * warp + g;  // this lane's keys (rows of S^T, dP^T, dK, dV): kl0, kl0 + 8
    const int n_steps = (T + kQS - 1) / kQS;
    const uint64_t seed = kDrop ? (uint64_t)*a.seed : 0;

    // 4 columns c .. c + 3 of row `row` of head h of a (B, rows, H, hd)
    // tensor; zeros for rows past nrows and columns past hd
    auto load4 = [&](const float* src, long long bs, long long rs, int row, int nrows, int c) {
        if (row < nrows && c < hd)
            return __ldg(reinterpret_cast<const float4*>(src + b * bs + row * rs +
                                                         (long long)h * hd + c));
        return make_float4(0.f, 0.f, 0.f, 0.f);
    };
    // x split into the hi and lo tiles at byte offset off
    auto store_split = [&](unsigned char* hi, unsigned char* lo, uint32_t off, float4 x) {
        const float2 p0 = usk::split_pair(x.x), p1 = usk::split_pair(x.y);
        const float2 p2 = usk::split_pair(x.z), p3 = usk::split_pair(x.w);
        *reinterpret_cast<float4*>(hi + off) = make_float4(p0.x, p1.x, p2.x, p3.x);
        *reinterpret_cast<float4*>(lo + off) = make_float4(p0.y, p1.y, p2.y, p3.y);
    };

    // K, V and K^T once: units of keys 4 a4 .. 4 a4 + 3 at columns 4 c
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int u = tid + i * kThreads64, a4 = u % 16, c = 4 * (u / 16);
        float4 k[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
            k[m] = load4(a.k, a.k_bs, a.k_rs, s0 + 4 * a4 + m, S, c);
            store_split(Kh, Kl, usk::sw_tf32(4 * a4 + m, c, kBKey), k[m]);
            store_split(Vh, Vl, usk::sw_tf32(4 * a4 + m, c, kBKey),
                        load4(a.v, a.v_bs, a.v_rs, s0 + 4 * a4 + m, S, c));
        }
        store_split(Kth, Ktl, usk::sw_tf32(c, 4 * a4, 64), make_float4(k[0].x, k[1].x, k[2].x, k[3].x));
        store_split(Kth, Ktl, usk::sw_tf32(c + 1, 4 * a4, 64), make_float4(k[0].y, k[1].y, k[2].y, k[3].y));
        store_split(Kth, Ktl, usk::sw_tf32(c + 2, 4 * a4, 64), make_float4(k[0].z, k[1].z, k[2].z, k[3].z));
        store_split(Kth, Ktl, usk::sw_tf32(c + 3, 4 * a4, 64), make_float4(k[0].w, k[1].w, k[2].w, k[3].w));
    }
    if (tid < kBKey) {
        const int s = s0 + tid;
        colneg[tid] = s >= S ? -INFINITY
                             : ((a.kpm != nullptr && a.kpm[(size_t)b * S + s] != 0) ? kPadNeg : 0.f);
    }

    // a step's q and dO: this thread copies queries 8 (qjp >> 1) + (qjp & 1)
    // + 2 m (m = 0..3) at columns 4 qc by cp.async into the fp32 staging
    // (threads < 24 the step's rows), then splits the same elements into q,
    // dO (rows of the head dim's columns) and q^T, dO^T (the queries of each
    // group of 8 in P's k order: columns 8 (qjp >> 1) + 4 (qjp & 1) + m)
    const float* rows_src = a.rows + (size_t)(b * a.H + h) * a.n_qt * kRowFloats;
    const int qjp = tid % 8, qc = 4 * (tid / 8);
    auto q_row = [&](int m) { return 8 * (qjp >> 1) + (qjp & 1) + 2 * m; };
    auto issue_step = [&](int t0, int buf) {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
            const int r = q_row(m), t = t0 + r;
            const bool ok = t < T && qc < hd;
            usk::cp_async16(stq + r * 64 + qc,
                            ok ? a.q + b * a.q_bs + t * a.q_rs + (long long)h * hd + qc : a.q, ok);
            usk::cp_async16(stdo + r * 64 + qc,
                            ok ? a.dout + b * a.do_bs + t * a.do_rs + (long long)h * hd + qc : a.dout,
                            ok);
        }
        if (tid < 3 * kQS / 4)
            usk::cp_async16(rows + buf * 3 * kQS + 4 * tid,
                            rows_src + (size_t)(t0 / kBQ) * kRowFloats + (tid / 8) * kBQ + t0 % kBQ +
                                4 * (tid % 8),
                            true);
        usk::cp_async_commit();
    };
    // the bias tile of the step at t0 into bias_s (rows past T and chunks
    // from S on as zeros; a chunk that starts below S lies inside its row,
    // rows being a multiple of 8 floats and at least S apart)
    auto issue_bias = [&](int t0) {
#pragma unroll
        for (int i = 0; i < kQS * kBKey / 4 / kThreads64; ++i) {
            const int ci = tid + i * kThreads64, r = ci / 16, c = 4 * (ci % 16);
            const bool ok = t0 + r < T && s0 + c < S;
            usk::cp_async16(bias_s + r * kLdBias + c,
                            ok ? a.bias + ((size_t)h * T + t0 + r) * a.bias_rs + s0 + c : a.bias, ok);
        }
        usk::cp_async_commit();
    };
    auto store_step = [&]() {
        float4 x[4], y[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
            x[m] = *reinterpret_cast<const float4*>(stq + q_row(m) * 64 + qc);
            y[m] = *reinterpret_cast<const float4*>(stdo + q_row(m) * 64 + qc);
            store_split(Qh, Ql, usk::sw_tf32(q_row(m), qc, kQS), x[m]);
            store_split(Dh, Dl, usk::sw_tf32(q_row(m), qc, kQS), y[m]);
        }
        const int col = 8 * (qjp >> 1) + 4 * (qjp & 1);
        store_split(Qth, Qtl, usk::sw_tf32(qc, col, 64), make_float4(x[0].x, x[1].x, x[2].x, x[3].x));
        store_split(Qth, Qtl, usk::sw_tf32(qc + 1, col, 64), make_float4(x[0].y, x[1].y, x[2].y, x[3].y));
        store_split(Qth, Qtl, usk::sw_tf32(qc + 2, col, 64), make_float4(x[0].z, x[1].z, x[2].z, x[3].z));
        store_split(Qth, Qtl, usk::sw_tf32(qc + 3, col, 64), make_float4(x[0].w, x[1].w, x[2].w, x[3].w));
        store_split(Dth, Dtl, usk::sw_tf32(qc, col, 64), make_float4(y[0].x, y[1].x, y[2].x, y[3].x));
        store_split(Dth, Dtl, usk::sw_tf32(qc + 1, col, 64), make_float4(y[0].y, y[1].y, y[2].y, y[3].y));
        store_split(Dth, Dtl, usk::sw_tf32(qc + 2, col, 64), make_float4(y[0].z, y[1].z, y[2].z, y[3].z));
        store_split(Dth, Dtl, usk::sw_tf32(qc + 3, col, 64), make_float4(y[0].w, y[1].w, y[2].w, y[3].w));
    };
    issue_step(0, 0);
    if (kBias) issue_bias(0);
    usk::cp_async_wait<0>();
    store_step();
    if (n_steps > 1) issue_step(kQS, 1);
    usk::fence_proxy_async();  // the tiles visible to wgmma
    __syncthreads();

    float dk[32], dv[32];  // element 4 n + e: key kl0 + 8 (e >> 1), column 8 n + 2 tq + (e & 1)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

    for (int it = 0; it < n_steps; ++it) {
        const int t0 = it * kQS;
        const float* rw = rows + (it & 1) * 3 * kQS;

        // S^T = K.q^T and dP^T = V.dO^T (64 keys x 32 queries), three
        // products per 8 columns (lo.hi, hi.lo, hi.hi) summed by the tensor
        // cores over kD; element 4 n + e: key kl0 + 8 (e >> 1), query 8 n +
        // 2 tq + (e & 1). (The forward adds each 8 columns' sum by an fp32 add:
        // a logit behind the -1e4 (T, S) mask rounds at 1e-3 there; such rows
        // carry dO = 0 into the backward, which multiplies their p by 0.)
        float st[16], dpt[16];
        uint32_t keep = 0xffffffffu;  // bit 4 n + e: element 4 n + e
        usk::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
            const uint32_t oa = (kk / 4) * (kBKey * 128) + (kk % 4) * 32;
            const uint32_t ob = (kk / 4) * (kQS * 128) + (kk % 4) * 32;
            const uint64_t dkh = dKh + (oa >> 4), dvh = dVh + (oa >> 4);
            const uint64_t dqh = dQh + (ob >> 4), ddh = dDh + (ob >> 4);
            usk::wgmma_m64n32k8_ss_tf32(st, dKl + (oa >> 4), dqh, kk > 0);
            usk::wgmma_m64n32k8_ss_tf32(st, dkh, dQl + (ob >> 4), 1);
            usk::wgmma_m64n32k8_ss_tf32(st, dkh, dqh, 1);
            usk::wgmma_m64n32k8_ss_tf32(dpt, dVl + (oa >> 4), ddh, kk > 0);
            usk::wgmma_m64n32k8_ss_tf32(dpt, dvh, dDl + (ob >> 4), 1);
            usk::wgmma_m64n32k8_ss_tf32(dpt, dvh, ddh, 1);
        }
        usk::wgmma_commit();
        // while the products run: the keep bits
        if (kDrop) {
            uint32_t own = 0, other = 0;
#pragma unroll
            for (int m = 0; m < 2; ++m) {
                const int n = 2 * m + (g & 1);
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const int s = s0 + kl0 + 8 * i, t = t0 + 8 * n + 2 * tq;
                    const usk::Philox4 w = usk::philox4x32_10(
                        (uint32_t)(s >> 1), (uint32_t)(t >> 1), (uint32_t)h, (uint32_t)b,
                        (uint32_t)seed, (uint32_t)(seed >> 32));
                    // word (s & 1) | (t & 1) << 1: this key's (t, t + 1) and the other key's
                    const uint32_t e0 = (g & 1) ? w.x[1] : w.x[0];
                    const uint32_t e1 = (g & 1) ? w.x[3] : w.x[2];
                    const uint32_t o0 = (g & 1) ? w.x[0] : w.x[1];
                    const uint32_t o1 = (g & 1) ? w.x[2] : w.x[3];
                    const int sh = 4 * n + 2 * i;
                    own |= ((uint32_t)(e0 >= a.threshold) | (uint32_t)(e1 >= a.threshold) << 1)
                           << sh;
                    other |= ((uint32_t)(o0 >= a.threshold) | (uint32_t)(o1 >= a.threshold) << 1)
                             << sh;
                }
            }
            keep = own | __shfl_xor_sync(0xffffffffu, other, 4);
        }
        usk::wgmma_wait<0>();
        usk::fence_regs(st);
        usk::fence_regs(dpt);

        // p, p c and dS per element; st becomes p c, dpt dS
        float dg[4][2];  // dS * bias summed over this lane's keys
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
        // dV += (p c)^T.dO: A = (p c)^T from the registers (k index permuted:
        // k tq <-> query 2 tq, k tq + 4 <-> 2 tq + 1; dO^T's columns are in
        // that order), three products per 8 queries into a fresh accumulator;
        // meanwhile dS (query, key) goes split into the dS tile for dq^,
        // gate * dS into the dbias staging boxes (both free: the last step's
        // dq^ products were waited on, and thread 0 saw its reductions read
        // the boxes, before the last barrier), and the dgate sums
        {
            uint32_t ph[4][4], pl[4][4];
#pragma unroll
            for (int n = 0; n < 4; ++n) {
                usk::split_tf32(st[4 * n + 0], ph[n][0], pl[n][0]);
                usk::split_tf32(st[4 * n + 2], ph[n][1], pl[n][1]);
                usk::split_tf32(st[4 * n + 1], ph[n][2], pl[n][2]);
                usk::split_tf32(st[4 * n + 3], ph[n][3], pl[n][3]);
            }
            float dvt[32];
            usk::wgmma_fence();
#pragma unroll
            for (int n = 0; n < 4; ++n) {
                const uint64_t dh = dDth + 2 * n;
                usk::wgmma_m64n64k8_rs_tf32(dvt, pl[n], dh, n > 0);
                usk::wgmma_m64n64k8_rs_tf32(dvt, ph[n], dDtl + 2 * n, 1);
                usk::wgmma_m64n64k8_rs_tf32(dvt, ph[n], dh, 1);
            }
            usk::wgmma_commit();
#pragma unroll
            for (int n = 0; n < 4; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int kl = kl0 + 8 * (e >> 1), ql = 8 * n + 2 * tq + (e & 1);
                    const float2 sp = usk::split_pair(dpt[4 * n + e]);
                    const uint32_t off = usk::sw_tf32(ql, kl, kQS);
                    *reinterpret_cast<float*>(Sh + off) = sp.x;
                    *reinterpret_cast<float*>(Sl + off) = sp.y;
                    if (kBias)
                        *reinterpret_cast<float*>(gd_box + (kl >> 5) * kBox + usk::sw_tf32(ql, kl & 31, kQS)) =
                            __fmul_rn(rw[2 * kQS + ql], dpt[4 * n + e]);
                }
            usk::fence_proxy_async();  // the dS tile visible to wgmma, the boxes to the TMA unit
            if (kBias && a.dgate != nullptr) {
                // over the 8 lanes of a column (g) of this warp; the 4 warps'
                // sums are added after the barrier
#pragma unroll
                for (int n = 0; n < 4; ++n)
#pragma unroll
                    for (int c = 0; c < 2; ++c) {
                        float v = dg[n][c];
                        v += __shfl_xor_sync(0xffffffffu, v, 4);
                        v += __shfl_xor_sync(0xffffffffu, v, 8);
                        v += __shfl_xor_sync(0xffffffffu, v, 16);
                        if (g == 0) dgs[warp * kQS + 8 * n + 2 * tq + c] = v;
                    }
            }
            usk::wgmma_wait<0>();
            usk::fence_regs(dvt);
#pragma unroll
            for (int n = 0; n < 4; ++n) {
                usk::fence_regs(ph[n]);
                usk::fence_regs(pl[n]);
            }
#pragma unroll
            for (int i = 0; i < 32; ++i) dv[i] += dvt[i];
        }

        // dK += dS^T.q^ as dV, A = dS^T from the registers, B = q^T
        uint32_t sh_[4][4], sl[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
            usk::split_tf32(dpt[4 * n + 0], sh_[n][0], sl[n][0]);
            usk::split_tf32(dpt[4 * n + 2], sh_[n][1], sl[n][1]);
            usk::split_tf32(dpt[4 * n + 1], sh_[n][2], sl[n][2]);
            usk::split_tf32(dpt[4 * n + 3], sh_[n][3], sl[n][3]);
        }
        float dkt[32];
        usk::wgmma_fence();
#pragma unroll
        for (int n = 0; n < 4; ++n) {
            const uint64_t qh = dQth + 2 * n;
            usk::wgmma_m64n64k8_rs_tf32(dkt, sl[n], qh, n > 0);
            usk::wgmma_m64n64k8_rs_tf32(dkt, sh_[n], dQtl + 2 * n, 1);
            usk::wgmma_m64n64k8_rs_tf32(dkt, sh_[n], qh, 1);
        }
        usk::wgmma_commit();
        __syncthreads();  // the dS tile and the dgate sums are complete; the bias tile consumed
        if (kBias && it + 1 < n_steps) issue_bias(t0 + kQS);  // lands before this step ends

        if (kBias && a.dgate != nullptr && tid < kQS && t0 + tid < T)
            atomicAdd(a.dgate + ((size_t)b * a.H + h) * T + t0 + tid,
                      (dgs[tid] + dgs[kQS + tid]) + (dgs[2 * kQS + tid] + dgs[3 * kQS + tid]));

        // dq^T = K^T.dS^T (columns of the head dim x 32 queries) over the
        // tile's 64 keys: A = K^T, B = the dS tile, both K-major
        float dqt[16];  // element 4 n + e: column kl0 + 8 (e >> 1), query 8 n + 2 tq + (e & 1)
        usk::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
            const uint32_t oa = (kk / 4) * (64 * 128) + (kk % 4) * 32;
            const uint32_t ob = (kk / 4) * (kQS * 128) + (kk % 4) * 32;
            const uint64_t dkh = dKth + (oa >> 4), dsh = dSh + (ob >> 4);
            usk::wgmma_m64n32k8_ss_tf32(dqt, dKtl + (oa >> 4), dsh, kk > 0);
            usk::wgmma_m64n32k8_ss_tf32(dqt, dkh, dSl + (ob >> 4), 1);
            usk::wgmma_m64n32k8_ss_tf32(dqt, dkh, dsh, 1);
        }
        usk::wgmma_commit();
        usk::wgmma_wait<1>();  // dK's group
        usk::fence_regs(dkt);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
            usk::fence_regs(sh_[n]);
            usk::fence_regs(sl[n]);
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) dk[i] += dkt[i];
        usk::wgmma_wait<0>();
        usk::fence_regs(dqt);
        // dq^ (query, column) into the staging boxes of 32 columns
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int col = kl0 + 8 * (e >> 1), ql = 8 * n + 2 * tq + (e & 1);
                *reinterpret_cast<float*>(dq_box + (col >> 5) * kBox + usk::sw_tf32(ql, col & 31, kQS)) =
                    dqt[4 * n + e];
            }
        usk::cp_async_wait<0>();  // the next step's q, dO and rows (this thread's copies)
        usk::fence_proxy_async();
        __syncthreads();  // the staging boxes are complete; this step's tiles consumed
        if (tid == 0) {
#pragma unroll
            for (int bx = 0; bx < 2; ++bx)
                if (32 * bx < hd) usk::tma_reduce_add_4d(&maps.dq, dq_box + bx * kBox, 32 * bx, h, t0, b);
            if (kBias) {
                usk::tma_reduce_add_3d(&maps.dbias, gd_box, s0, t0, h);
                usk::tma_reduce_add_3d(&maps.dbias, gd_box + kBox, s0 + 32, t0, h);
            }
            usk::bulk_commit();
        }
        if (it + 1 < n_steps) {
            store_step();
            if (it + 2 < n_steps) issue_step(t0 + 2 * kQS, it & 1);
        }
        if (tid == 0) usk::bulk_wait_read<0>();  // the boxes are free for the next step's writes
        usk::fence_proxy_async();
        __syncthreads();  // the next step's tiles are complete
    }
    if (tid == 0) usk::bulk_wait();

    // dK (times the scale) and dV of this lane's keys, columns below hd
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int s = s0 + kl0 + 8 * i;
        if (s >= S) continue;
        const size_t row = (((size_t)b * S + s) * a.H + h) * hd + 2 * tq;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
            if (8 * n >= hd) break;
            *reinterpret_cast<float2*>(a.dk + row + 8 * n) =
                make_float2(dk[4 * n + 2 * i] * a.scale, dk[4 * n + 2 * i + 1] * a.scale);
            *reinterpret_cast<float2*>(a.dv + row + 8 * n) =
                make_float2(dv[4 * n + 2 * i], dv[4 * n + 2 * i + 1]);
        }
    }
}

// The first form, for kD = 128: fp32 tiles split at every fragment read,
// 64-query steps, fp32 atomics for dq^ and dbias (see the head of the file).
// Warp w owns keys [16 (w % 4), +16) and queries [32 (w / 4), +32) of S^T
// and dP^T, a partial dK and dV over its half of the queries, and dq^ of
// queries [16 (w % 4), +16) and columns [kD/2 (w / 4), +kD/2); K, V, q, dO
// and the bias tile arrive by 16-byte cp.async in row strides of hd + 4
// (68 for the bias) floats.
template <int kD, bool kBias, bool kDrop>
__global__ void __launch_bounds__(kThreadsWide) flash_bwd_f32_wide_kernel(const Args a) {
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
        for (int i = tid; i < 64 * n4; i += kThreadsWide) {
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
            for (int i = tid; i < kBQ * (kBKey / 4); i += kThreadsWide) {
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
                        atomicAdd(a.dbias + ((size_t)h * T + t) * a.dbias_rs + s, __fmul_rn(rows[2 * kBQ + ql], ds));
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

template <bool kBias, bool kDrop>
cudaError_t launch64(const Maps& maps, const Args& a, dim3 grid, cudaStream_t st) {
    auto kernel = flash_bwd_f32_kernel<kBias, kDrop>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem64);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads64, kSmem64, st>>>(maps, a);
    return cudaGetLastError();
}

template <bool kBias, bool kDrop>
cudaError_t launch_wide(const Args& a, dim3 grid, cudaStream_t st) {
    auto kernel = flash_bwd_f32_wide_kernel<128, kBias, kDrop>;
    const int smem = ((kBKey + kBQ) * 2 * (a.hd + 4) + 2 * kBQ * kLdB + kRowFloats + kBKey + kBQ) *
                     (int)sizeof(float);
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreadsWide, smem, st>>>(a);
    return cudaGetLastError();
}

cudaError_t launch(const Maps& maps, const Args& a, dim3 grid, cudaStream_t st) {
    const bool bias = a.bias != nullptr, drop = a.seed != nullptr;
    if (a.hd <= 64) {
        if (bias) return drop ? launch64<true, true>(maps, a, grid, st)
                              : launch64<true, false>(maps, a, grid, st);
        return drop ? launch64<false, true>(maps, a, grid, st) : launch64<false, false>(maps, a, grid, st);
    }
    if (bias) return drop ? launch_wide<true, true>(a, grid, st) : launch_wide<true, false>(a, grid, st);
    return drop ? launch_wide<false, true>(a, grid, st) : launch_wide<false, false>(a, grid, st);
}

}  // namespace

// q, out, dout (B, T, H, hd) and k, v (B, S, H, hd) fp32 by (batch, row)
// strides in elements, rows of H hd contiguous floats, 16-byte aligned; lse
// (B, H, T) fp32; bias (H, T, S) fp32 with rows bias_rs (a multiple of 8,
// >= S) apart, or null; gate (B, H, T) fp32 or null; kpm (B, S) bool or
// null; amask (T, S) fp32 or null; dk, dv (B, S, H, hd) contiguous fp32; dq
// (B, T, H, hd), dgate (B, H, T) and dbias (H, T, ceil(S/64) * 64) zeroed
// contiguous fp32 buffers (dgate, dbias null without gate / bias); rows
// (B * H, ceil(T/64), 3, 64) fp32 scratch; seed a 1-element int64 or null;
// hd a multiple of 8 up to 128
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
    const int n_kt = (S + kBKey - 1) / kBKey;
    Maps maps = {};
    if (hd <= 64) {
        const uint64_t qdims[4] = {(uint64_t)hd, (uint64_t)H, (uint64_t)T, (uint64_t)B};
        const uint64_t qstrides[3] = {(uint64_t)hd * 4, (uint64_t)H * hd * 4,
                                      (uint64_t)T * H * hd * 4};
        const uint32_t qbox[4] = {32, 1, kQS, 1};
        if (!usk::make_tensor_map(&maps.dq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, dq, qdims, qstrides,
                                  qbox, CU_TENSOR_MAP_SWIZZLE_128B))
            return (int)cudaErrorInvalidValue;
        maps.dbias = maps.dq;  // unused without a bias
        if (bias != nullptr) {
            const uint64_t gdims[3] = {(uint64_t)n_kt * kBKey, (uint64_t)T, (uint64_t)H};
            const uint64_t gstrides[2] = {(uint64_t)n_kt * kBKey * 4,
                                          (uint64_t)n_kt * kBKey * T * 4};
            const uint32_t gbox[3] = {32, kQS, 1};
            if (!usk::make_tensor_map(&maps.dbias, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, dbias, gdims,
                                      gstrides, gbox, CU_TENSOR_MAP_SWIZZLE_128B))
                return (int)cudaErrorInvalidValue;
        }
    }
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
    a.dbias_rs = (long long)n_kt * kBKey;
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
    return (int)launch(maps, a, dim3(n_kt, H, B), s);
}
