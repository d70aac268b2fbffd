// Fused attention backward (merged: dq, dk, dv, dgate, dbias in one pass).
//
// Replaces unispeech_tpu/ops/pallas/flash_attention.py::_bwd_kernel
// (head-major layout, launched by _run_backward) and ::_bwd_kernel_packed
// (natural layout, launched by _run_backward_packed). With q^ = bf16(q *
// scale) and p = exp(s - lse) recomputed from the forward's inputs and lse,
// c = keep / (1 - rate) regenerated from the seed (philox.cuh), and
// delta = rowsum(dO * out):
//   dP = dO . v^T,  dS = p * (c * dP - delta)
//   dq^ = dS . k,  dk = dS^T . q^,  dv = (p * c)^T . dO
//   dgate[b,h,t] = sum_s dS * bias,  dbias[h,t,s] = sum_b gate * dS
// dS and p * c are rounded to bf16 as matrix-product operands, as the TPU
// kernel does; dgate and dbias use the fp32 dS. The q scale: where
// hd**-0.5 in bf16 is a power of two (hd 16, 64) bf16(q * scale) is q *
// scale exactly, and the kernel multiplies q.k and dS^T.q by it in fp32;
// at any other hd the wrapper passes the pre-scaled q^ (as the forward
// does) and scale 1, so dk = dS^T.q^ with the rounded q^, as the plain
// version forms it. dq^ is unscaled: the wrapper forms dq = bf16(dq^) *
// scale, the chain rule through q * scale.
// Head dims: any multiple of 8 up to 128 (the wrapper zero-pads any other
// hd), a template on the padded width kD, 64 or 128. The maps' hd extent is
// the true hd (columns past it load as zeros). dK and dV of a 64-key tile
// stay in registers for the whole query loop, 64 x kD fp32 each, which at
// kD = 128 with the S^T, dP^T and dq^ accumulators would not fit in 255
// registers. So at kD = 128 the block is two warpgroups: warpgroup w
// holds dK, dV and dq^ of columns [64 w, 64 w + 64), and S^T and dP^T of
// queries [32 w, 32 w + 32) (wgmma N = 32); each writes its half of dS^T
// and (p c)^T to shared memory, and after a barrier each takes all 64
// queries of both as the A operand from there. No product runs twice:
// two one-warpgroup blocks per key tile, one per 64 columns, each forming
// S^T and dP^T over all of them, do 1.4x the tensor work in one 4-warp
// block per SM and measured 1.6x slower at HuBERT X-Large's shape (PERF.md).
//
// Bound on the H100: operations. At the WavLM-Base pretraining shape
// (6 x 768 frames, 12 heads) one call does 5 products of 2*B*H*T*S*64
// FLOP, 27.2 GFLOP (27 us at the bf16 tensor-core peak), against ~30 MB of
// inputs and outputs (9 us at 3.35 TB/s), plus one exp and, with dropout, a
// quarter of a Philox call per (t, s).
// Design (Hopper), kD / 64 warpgroups per (64-key tile, head, utterance),
// looping over 64-query tiles; two blocks per SM at kD = 64 (108 KB of
// shared memory), one at kD = 128 (8 warps, 180 KB):
//  - loads: K and V once, then per query tile q, dO and the bias tile by
//    TMA (128-byte swizzled boxes of 64 rows x 64 columns, kD / 64 per row
//    tile; rows past T or S load as zeros)
//    and the tile's lse, delta and gate by one bulk copy, into a 2-stage
//    ring on mbarriers: thread 0 issues tile i + 1 while tile i computes;
//  - products on wgmma, fp32 accumulators in registers:
//      S^T = K.q^T and dP^T = V.dO^T (64 keys x 64 / (kD / 64) queries,
//        both operands K-major from shared memory),
//      dV += (P*c)^T.dO and dK += dS^T.q (at kD = 64 A from registers: the
//        S^T / dP^T accumulators converted to bf16 fragments in place; at
//        kD = 128 A = (p c)^T and dS^T from shared memory; B = dO / q read
//        MN-major from the same tiles), dK and dV in registers for the
//        whole loop and written once,
//      dq^ = dS.K (A = dS^T written to shared memory in the swizzled layout
//        and read MN-major, B = K read MN-major);
//  - cross-block sums by the TMA unit's reductions (fp32 add into global
//    memory from shared memory) instead of scalar atomics: dq^ of a tile
//    into a (B, T, H, hd) buffer and gate * dS into a (H, T, S64) dbias
//    buffer (rows padded to 64 keys), each as two 64-row x 32-float boxes
//    through tensor maps (128-byte swizzled staging, conflict-free writes;
//    rows past T are clipped), and the per-warp dgate partials into a
//    (B * H, T64) buffer by one 256-byte bulk reduction each. Four tensor
//    operations per tile instead of 128 row reductions made the kernel
//    1.15x faster;
//  - the dropout mask: one Philox call gives the words of a 2 x 2 (query,
//    key) block; the two lanes that hold the block's two keys each compute
//    half of their calls and swap the other lane's words by a shuffle; drawn
//    while S^T and dP^T are on the tensor cores;
//  - the per-element work (p, dS, the keep mask, dS^T and gate * dS to shared
//    memory) is one straight-line block: bias, gate, dropout and the
//    (T, S) mask are template flags, not runtime branches (runtime flags made
//    the kernel 1.1-1.5x slower), and p = 2^(x log2 e - lse log2 e) is one FMA
//    and one ex2.
// A pre-pass (rows_kernel) forms delta = rowsum(dO * out) and packs lse *
// log2 e, delta and gate per query tile (inf, 0, 1 past T). The order of
// the fp32 bulk additions varies from run to run, so dq, dgate and dbias
// agree with the plain version to fp32 rounding of a sum of (S/64, S/64, B)
// terms, below one bf16 ulp of the outputs.

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"
#include "philox.cuh"

namespace {

constexpr int kBKey = 64;   // keys per block
constexpr int kBQ = 64;     // queries per step
constexpr int kStages = 2;
constexpr int kMaxHd = 128;
constexpr uint32_t kTile = 64 * 128;         // 64 rows of 64 bf16, 128-byte swizzled
constexpr int kRowFloats = 3 * kBQ;          // lse, delta, gate of one query tile
constexpr uint32_t kRowBytes = kRowFloats * 4;
constexpr uint32_t kBox = 64 * 128;          // 64 rows of 32 fp32, 128-byte swizzled
constexpr float kLog2e = 1.4426950408889634f;
// a padded key's additive mask, exact under * log2 e (flash_attention.cu)
constexpr float kPadNeg = -1267650600228229401496703205376.0f;  // -2^100

// the width-kD kernel: kD / 64 warpgroups, warpgroup w owning columns
// [64 w, 64 w + 64) of dq^, dK and dV and queries [kQW w, kQW w + kQW) of
// S^T and dP^T; shared memory from a 1024-byte aligned base, a row tile
// (K, V, q or dO) kD / 64 boxes of kTile bytes
template <int kD>
struct Plan {
    static constexpr int kWG = kD / 64;
    static constexpr int kThreads = 128 * kWG;
    static constexpr int kQW = kBQ / kWG;  // queries of S^T per warpgroup
    static constexpr uint32_t kRowTile = kWG * kTile;
    static constexpr uint32_t kOffK = 0;
    static constexpr uint32_t kOffV = kRowTile;
    static constexpr uint32_t kOffDS = 2 * kRowTile;              // dS^T [key][query] bf16
    static constexpr uint32_t kOffP = kOffDS + kTile;             // (p c)^T [key][query] (kWG > 1)
    static constexpr uint32_t kOffStage = kOffP + (kWG > 1 ? kTile : 0);  // q, dO, bias, rows
    static constexpr uint32_t kStageQ = 0, kStageD = kRowTile, kStageB = 2 * kRowTile;
    static constexpr uint32_t kStageRows = 2 * kRowTile + kTile;
    static constexpr uint32_t kStageBytes = 2 * kRowTile + kTile + 1024;
    static constexpr uint32_t kOffDq = kOffStage + kStages * kStageBytes;  // dq^ 32-column boxes
    static constexpr uint32_t kOffGd = kOffDq + 2 * kWG * kBox;            // gate*dS [key half] boxes
    static constexpr uint32_t kOffDg = kOffGd + 2 * kBox;                  // dgate [warp][query]
    static constexpr uint32_t kOffBar = kOffDg + 4 * kBQ * 4;              // full[2], kv
    static constexpr uint32_t kOffColneg = kOffBar + 64;
    static constexpr size_t kSmemBytes = 1024 + kOffColneg + kBKey * 4;
    static constexpr int kMinBlocks = kWG == 1 ? 2 : 1;
};

struct Maps {
    CUtensorMap q, k, v, dout;  // (B, rows, H, hd) by strides: dims {hd, H, rows, B}
    CUtensorMap bias;           // (H, T, S) with row stride bias_rs: dims {S, T, H}
    CUtensorMap dq;             // fp32 (B, T, H, hd): dims {hd, H, T, B}, boxes of 32 x 64 rows
    CUtensorMap dbias;          // fp32 (H, T, S64): dims {S64, T, H}, boxes of 32 x 64 rows
};

struct Args {
    const __nv_bfloat16 *out, *dout;  // for delta
    const float* lse;                 // (B, H, T)
    long long o_bs, o_rs, do_bs, do_rs;  // elements
    const __nv_bfloat16* bias;  // (H, T, S) or null
    const float* gate;          // (B, H, T) or null (gate 1 with bias)
    const uint8_t* kpm;         // (B, S) 1 = padded key, or null
    const float* amask;         // (T, S) or null
    float* rows;                // (B * H, n_qt, 3, 64): lse log2 e, delta, gate per query tile
    float* dq;                  // (B, T, H, hd) fp32, zeroed: dq^ = dS . k
    __nv_bfloat16* dk;          // (B, S, H, hd)
    __nv_bfloat16* dv;          // (B, S, H, hd)
    float* dgate;               // (B * H, n_qt * 64) zeroed, or null
    float* dbias;               // (H, T, n_kt * 64) fp32 zeroed, or null
    const long long* seed;      // dropout seed or null
    unsigned threshold;
    float drop_scale;
    int T, S, H, hd, n_qt, n_kt;
    float scale;
};

// byte offset of fp32 element (r, c) of a 128-byte-swizzled box of 32 per row
__device__ __forceinline__ uint32_t sw128_f32(int r, int c) {
    return (uint32_t)r * 128u + ((((uint32_t)c >> 2) ^ (uint32_t)(r & 7)) << 4) + ((uint32_t)c & 3u) * 4u;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// a 64-key x (16 or 8 query-pair) product step of S^T or dP^T at the
// warpgroup's query width
__device__ __forceinline__ void st_step(float (&d)[32], uint64_t da, uint64_t db) {
    usk::wgmma_m64n64k16_ss<0, 0>(d, da, db);
}
__device__ __forceinline__ void st_step(float (&d)[16], uint64_t da, uint64_t db) {
    usk::wgmma_m64n32k16_ss<0, 0>(d, da, db);
}

// rows[(b*H + h), t / 64, :, t % 64] = (lse * log2 e, delta = sum_d dO * out, gate)
// for t < n_qt * 64, (inf, 0, 1) past T: 8 lanes per (b, h, t), each over
// the 8-column slices part, part + 8, ... below hd
__global__ void __launch_bounds__(256) rows_kernel(const Args a, int total) {
    const int r = blockIdx.x * 32 + threadIdx.x / 8;
    const int part = threadIdx.x % 8;
    const int tp = a.n_qt * kBQ;
    const int bh = r / tp, t = r % tp;
    const int b = bh / a.H, h = bh % a.H;
    const bool ok = r < total && t < a.T;
    float acc = 0.f;
    if (ok) {
        for (int c = part * 8; c < a.hd; c += 64) {
            const uint4 o4 = *reinterpret_cast<const uint4*>(
                a.out + b * a.o_bs + t * a.o_rs + h * a.hd + c);
            const uint4 d4 = *reinterpret_cast<const uint4*>(
                a.dout + b * a.do_bs + t * a.do_rs + h * a.hd + c);
            const __nv_bfloat16* o = reinterpret_cast<const __nv_bfloat16*>(&o4);
            const __nv_bfloat16* d = reinterpret_cast<const __nv_bfloat16*>(&d4);
#pragma unroll
            for (int i = 0; i < 8; ++i) acc = fmaf(usk::bf2f(d[i]), usk::bf2f(o[i]), acc);
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

// kD: the padded head dim (64: one warpgroup; 128: two, see Plan). kBias: a
// bias tile per query tile (and dbias); kGate: the bias is gated (and
// dgate); kDrop: dropout; kMask: an additive (T, S) mask. Compile-time
// flags keep the per-element work one straight-line block.
template <int kD, bool kBias, bool kGate, bool kDrop, bool kMask>
__global__ void __launch_bounds__(Plan<kD>::kThreads, Plan<kD>::kMinBlocks)
    flash_bwd_kernel(const __grid_constant__ Maps maps, const Args a) {
    using P = Plan<kD>;
    constexpr int kQW = P::kQW;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    unsigned char* Ks = smem + P::kOffK;
    unsigned char* Vs = smem + P::kOffV;
    unsigned char* dSt = smem + P::kOffDS;
    unsigned char* Pt = smem + P::kOffP;
    unsigned char* dqs = smem + P::kOffDq;
    unsigned char* Gd = smem + P::kOffGd;
    float* dgs = reinterpret_cast<float*>(smem + P::kOffDg);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kOffBar);
    uint64_t* kv_bar = full + kStages;
    float* colneg = reinterpret_cast<float*>(smem + P::kOffColneg);

    const int s0 = blockIdx.x * kBKey, h = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x, lane = tid % 32;
    // warpgroup, warp in it (compile-time 0 and tid / 32 with one warpgroup)
    const int wg = P::kWG == 1 ? 0 : tid / 128;
    const int warp = P::kWG == 1 ? tid / 32 : (tid / 32) % 4;
    const int qoff = wg * kQW;  // this warpgroup's first query of S^T
    const int c0 = wg * 64;     // its first column of dq^, dK, dV
    const int T = a.T, S = a.S, H = a.H, n_qt = a.n_qt;
    const uint64_t seed = kDrop ? (uint64_t)*a.seed : 0;
    const int g = lane >> 2, c2 = (lane & 3) * 2;
    const int half = g & 1;  // this lane's key parity; lane ^ 4 holds the other key

    auto stage = [&](int st) { return smem + P::kOffStage + st * P::kStageBytes; };
    // tile qt's q, dO, bias and rows into stage qt % 2
    auto issue = [&](int qt) {
        unsigned char* sp = stage(qt % kStages);
        uint64_t* bar = &full[qt % kStages];
        usk::mbar_expect_tx(bar, 2 * P::kRowTile + (kBias ? kTile : 0) + kRowBytes);
#pragma unroll
        for (int bx = 0; bx < P::kWG; ++bx) {
            usk::tma_load_4d(sp + P::kStageQ + bx * kTile, &maps.q, bar, bx * 64, h, qt * kBQ, b);
            usk::tma_load_4d(sp + P::kStageD + bx * kTile, &maps.dout, bar, bx * 64, h, qt * kBQ, b);
        }
        if (kBias) usk::tma_load_3d(sp + P::kStageB, &maps.bias, bar, s0, qt * kBQ, h);
        usk::bulk_load(sp + P::kStageRows, a.rows + ((size_t)(b * H + h) * n_qt + qt) * kRowFloats,
                       kRowBytes, bar);
    };

    if (tid == 0) {
        usk::mbar_init(&full[0], 1);
        usk::mbar_init(&full[1], 1);
        usk::mbar_init(kv_bar, 1);
        usk::fence_barrier_init();
    }
    __syncthreads();
    if (tid == 0) {
        usk::mbar_expect_tx(kv_bar, 2 * P::kRowTile);
#pragma unroll
        for (int bx = 0; bx < P::kWG; ++bx) {
            usk::tma_load_4d(Ks + bx * kTile, &maps.k, kv_bar, bx * 64, h, s0, b);
            usk::tma_load_4d(Vs + bx * kTile, &maps.v, kv_bar, bx * 64, h, s0, b);
        }
        issue(0);
    }
    if (tid < kBKey) {
        const int s = s0 + tid;
        colneg[tid] = s >= S ? -INFINITY
                      : (a.kpm != nullptr && a.kpm[(size_t)b * S + s]) ? kPadNeg : 0.f;
    }

    float dk[32], dv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
    // K-major descriptors step K by 32 bytes, MN-major ones by 16 rows
    const uint32_t kSbo = 1024, kLbo = kTile;
    // this warpgroup's 64 columns of the K tile
    const unsigned char* Kc = Ks + wg * kTile;
    usk::mbar_wait(kv_bar, 0);

    for (int qt = 0; qt < n_qt; ++qt) {
        const int q0 = qt * kBQ, st = qt % kStages;
        unsigned char* sp = stage(st);
        const unsigned char* Qs = sp + P::kStageQ;
        const unsigned char* Ds = sp + P::kStageD;
        const unsigned char* Bs = sp + P::kStageB;
        const float* rows = reinterpret_cast<const float*>(sp + P::kStageRows);
        __syncthreads();  // all threads are done with tile qt - 1 (its stage, colneg)
        if (tid == 0 && qt + 1 < n_qt) issue(qt + 1);
        usk::mbar_wait(&full[st], (qt / kStages) & 1);

        // S^T = K.q^T, dP^T = V.dO^T: 64 keys x this warpgroup's kQW
        // queries each, over all kD columns (four 16-column steps per box)
        float sacc[kQW / 2], dpacc[kQW / 2];
#pragma unroll
        for (int i = 0; i < kQW / 2; ++i) sacc[i] = dpacc[i] = 0.f;
        usk::fence_regs(sacc);
        usk::fence_regs(dpacc);
        usk::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
            const uint32_t off = (kk / 4) * kTile + (kk % 4) * 32;
            const uint32_t qrow = qoff * 128;  // the warpgroup's first query row
            st_step(sacc, usk::desc_sw128(Ks + off, 16, kSbo),
                    usk::desc_sw128(Qs + off + qrow, 16, kSbo));
            st_step(dpacc, usk::desc_sw128(Vs + off, 16, kSbo),
                    usk::desc_sw128(Ds + off + qrow, 16, kSbo));
        }
        usk::wgmma_commit();

        // the keep mask, bit ((j * 2 + e) * 2 + i) for key row g + 8e and
        // query qoff + 8j + c2 + i: this lane computes the calls of the j
        // with j % 2 == half and sends lane ^ 4 its words of them
        uint32_t keep = 0xffffffffu;
        if (kDrop) {
            keep = 0;
#pragma unroll
            for (int jj = 0; jj < kQW / 16; ++jj) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int j = 2 * jj + half;
                    const int s = s0 + warp * 16 + g + 8 * e, t = q0 + qoff + j * 8 + c2;
                    const usk::Philox4 w = usk::philox4x32_10(
                        (uint32_t)(s >> 1), (uint32_t)(t >> 1), (uint32_t)h, (uint32_t)b,
                        (uint32_t)seed, (uint32_t)(seed >> 32));
                    // word (s & 1) | (t & 1) << 1; t is even here
                    const uint32_t w_self0 = half ? w.x[1] : w.x[0], w_self1 = half ? w.x[3] : w.x[2];
                    const uint32_t w_other0 = half ? w.x[0] : w.x[1], w_other1 = half ? w.x[2] : w.x[3];
                    const uint32_t mine = (uint32_t)(w_self0 >= a.threshold) |
                                          ((uint32_t)(w_self1 >= a.threshold) << 1);
                    const uint32_t other = (uint32_t)(w_other0 >= a.threshold) |
                                           ((uint32_t)(w_other1 >= a.threshold) << 1);
                    const uint32_t recv = __shfl_xor_sync(0xffffffffu, other, 4);
                    keep |= mine << ((j * 2 + e) * 2);
                    keep |= recv << (((2 * jj + (half ^ 1)) * 2 + e) * 2);
                }
            }
        }

        usk::wgmma_wait<0>();
        usk::fence_regs(sacc);
        usk::fence_regs(dpacc);
        // the staging buffers are free once this thread's bulk reductions of
        // tile qt - 1 have read them
        usk::bulk_wait_read();
        __syncthreads();

        // p, p*c (into sacc) and dS (into dpacc); dS^T, (p c)^T (two
        // warpgroups) and gate*dS to shared memory
        float dgq[kQW / 8][2];
#pragma unroll
        for (int j = 0; j < kQW / 8; ++j) {
            dgq[j][0] = dgq[j][1] = 0.f;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int kr = warp * 16 + g + 8 * e;  // key row in the tile
                const int qc = qoff + j * 8 + c2;       // first of the query pair
                float ds2[2], pc2[2];
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const int qr = qc + i, idx = 4 * j + 2 * e + i;
                    float x = sacc[idx] * a.scale;
                    float braw = 0.f;
                    if (kBias) {
                        braw = usk::bf2f(*reinterpret_cast<const __nv_bfloat16*>(
                            Bs + usk::sw128_offset(qr, kr)));
                        x += rows[2 * kBQ + qr] * braw;
                    }
                    if (kMask) {
                        const int t = q0 + qr, s = s0 + kr;
                        x += (t < T && s < S) ? a.amask[(size_t)t * S + s] : 0.f;
                    }
                    x += colneg[kr];
                    const float p = usk::ex2(fmaf(x, kLog2e, -rows[qr]));
                    const bool kept = (keep >> ((j * 2 + e) * 2 + i)) & 1;
                    const float c = kDrop ? (kept ? a.drop_scale : 0.f) : 1.f;
                    const float ds = p * (c * dpacc[idx] - rows[kBQ + qr]);
                    sacc[idx] = p * c;
                    dpacc[idx] = ds;
                    ds2[i] = ds;
                    pc2[i] = p * c;
                    if (kGate) dgq[j][i] += ds * braw;
                    if (kBias)
                        *reinterpret_cast<float*>(Gd + (kr >> 5) * kBox + sw128_f32(qr, kr & 31)) =
                            rows[2 * kBQ + qr] * ds;
                }
                *reinterpret_cast<uint32_t*>(dSt + usk::sw128_offset(kr, qc)) =
                    pack_bf16(ds2[0], ds2[1]);
                if (P::kWG > 1)
                    *reinterpret_cast<uint32_t*>(Pt + usk::sw128_offset(kr, qc)) =
                        pack_bf16(pc2[0], pc2[1]);
            }
        }

        // dV += (p*c)^T . dO and dK += dS^T . q over this warpgroup's
        // columns (B MN-major), then dq^ = dS . K: 64 queries x its columns
        // over the tile's keys (A = dS^T read MN-major, B = K MN-major)
        const unsigned char* Dc = Ds + wg * kTile;
        const unsigned char* Qc = Qs + wg * kTile;
        uint32_t pa[kQW / 16][4], sa[kQW / 16][4];
        if constexpr (P::kWG == 1) {
            // one warpgroup holds all 64 queries: A fragments straight from
            // the accumulators (16 queries per step)
#pragma unroll
            for (int kk = 0; kk < kQW / 16; ++kk) {
                pa[kk][0] = pack_bf16(sacc[8 * kk + 0], sacc[8 * kk + 1]);
                pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
                pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
                pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
                sa[kk][0] = pack_bf16(dpacc[8 * kk + 0], dpacc[8 * kk + 1]);
                sa[kk][1] = pack_bf16(dpacc[8 * kk + 2], dpacc[8 * kk + 3]);
                sa[kk][2] = pack_bf16(dpacc[8 * kk + 4], dpacc[8 * kk + 5]);
                sa[kk][3] = pack_bf16(dpacc[8 * kk + 6], dpacc[8 * kk + 7]);
            }
            usk::fence_regs(dv);
            usk::fence_regs(dk);
            usk::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kQW / 16; ++kk)
                usk::wgmma_m64n64k16_rs<1>(dv, pa[kk], usk::desc_sw128(Dc + kk * 2048, kLbo, kSbo));
#pragma unroll
            for (int kk = 0; kk < kQW / 16; ++kk)
                usk::wgmma_m64n64k16_rs<1>(dk, sa[kk], usk::desc_sw128(Qc + kk * 2048, kLbo, kSbo));
            usk::wgmma_commit();
            usk::fence_proxy_async();  // dS^T visible to wgmma
            __syncthreads();
        } else {
            // each warpgroup holds half the queries: A = (p c)^T and dS^T
            // from shared memory, K-major, once both halves are written
            usk::fence_proxy_async();
            __syncthreads();
            usk::fence_regs(dv);
            usk::fence_regs(dk);
            usk::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kBQ / 16; ++kk)
                usk::wgmma_m64n64k16_ss<0, 1>(dv, usk::desc_sw128(Pt + kk * 32, 16, kSbo),
                                              usk::desc_sw128(Dc + kk * 2048, kLbo, kSbo));
#pragma unroll
            for (int kk = 0; kk < kBQ / 16; ++kk)
                usk::wgmma_m64n64k16_ss<0, 1>(dk, usk::desc_sw128(dSt + kk * 32, 16, kSbo),
                                              usk::desc_sw128(Qc + kk * 2048, kLbo, kSbo));
            usk::wgmma_commit();
        }
        float dq[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) dq[i] = 0.f;
        usk::fence_regs(dq);
        usk::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBKey / 16; ++kk)
            usk::wgmma_m64n64k16_ss<1, 1>(dq, usk::desc_sw128(dSt + kk * 2048, kLbo, kSbo),
                                          usk::desc_sw128(Kc + kk * 2048, kLbo, kSbo));
        usk::wgmma_commit();
        usk::wgmma_wait<0>();
        usk::fence_regs(dq);
        usk::fence_regs(dv);
        usk::fence_regs(dk);
        if constexpr (P::kWG == 1) {
#pragma unroll
            for (int kk = 0; kk < kQW / 16; ++kk) {
                usk::fence_regs(pa[kk]);
                usk::fence_regs(sa[kk]);
            }
        }

        // dq^ and the dgate partials to shared memory, then a TMA reduction
        // of each 32-wide box (dq^ below hd, gate * dS) and one bulk
        // reduction per warp's dgate partials
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int r = warp * 16 + g + 8 * e;
#pragma unroll
            for (int j = 0; j < 8; ++j)
                *reinterpret_cast<float2*>(dqs + (2 * wg + (j >> 2)) * kBox +
                                           sw128_f32(r, (j & 3) * 8 + c2)) =
                    make_float2(dq[4 * j + 2 * e], dq[4 * j + 2 * e + 1]);
        }
        if (kGate) {
#pragma unroll
            for (int j = 0; j < kQW / 8; ++j) {
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    float v = dgq[j][i];
                    v += __shfl_xor_sync(0xffffffffu, v, 4);
                    v += __shfl_xor_sync(0xffffffffu, v, 8);
                    v += __shfl_xor_sync(0xffffffffu, v, 16);
                    if (g == 0) dgs[warp * kBQ + qoff + j * 8 + c2 + i] = v;
                }
            }
        }
        usk::fence_proxy_async();
        __syncthreads();
        // (rows past T, columns past hd fall outside the maps and are not
        // written, whole boxes too)
        if (tid == 0) {
#pragma unroll
            for (int bx = 0; bx < 2 * P::kWG; ++bx)
                usk::tma_reduce_add_4d(&maps.dq, dqs + bx * kBox, bx * 32, h, q0, b);
            if (kBias) {
                usk::tma_reduce_add_3d(&maps.dbias, Gd, s0, q0, h);
                usk::tma_reduce_add_3d(&maps.dbias, Gd + kBox, s0 + 32, q0, h);
            }
        }
        if (kGate && tid < 4)
            usk::bulk_reduce_add_f32(a.dgate + (size_t)(b * H + h) * n_qt * kBQ + q0,
                                     dgs + tid * kBQ, kBQ * 4);
        if (tid < 4) usk::bulk_commit();
    }
    usk::bulk_wait();

    // dK (times the scale), dV of this warp's keys: rows g / g + 8, column
    // pairs of each 8-wide slice of the warpgroup's columns below hd
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        const int s = s0 + warp * 16 + g + 8 * e;
        if (s >= S) continue;
        const size_t base = ((size_t)((size_t)b * S + s) * H + h) * a.hd + c0 + c2;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            if (c0 + j * 8 >= a.hd) continue;
            *reinterpret_cast<__nv_bfloat162*>(a.dk + base + j * 8) = __floats2bfloat162_rn(
                dk[4 * j + 2 * e] * a.scale, dk[4 * j + 2 * e + 1] * a.scale);
            *reinterpret_cast<__nv_bfloat162*>(a.dv + base + j * 8) =
                __floats2bfloat162_rn(dv[4 * j + 2 * e], dv[4 * j + 2 * e + 1]);
        }
    }
}

// (B, rows, H, hd) bf16 by element strides (batch, row) as a 4D map of
// boxes of 64 rows x 64 columns; columns past hd load as zeros
bool head_map(CUtensorMap* m, const void* p, int B, int rows, int H, int hd, long long bs,
              long long rs) {
    const uint64_t dims[4] = {(uint64_t)hd, (uint64_t)H, (uint64_t)rows, (uint64_t)B};
    const uint64_t strides[3] = {(uint64_t)hd * 2, (uint64_t)rs * 2, (uint64_t)bs * 2};
    const uint32_t box[4] = {64, 1, 64, 1};
    return usk::make_tensor_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, p, dims, strides, box,
                                CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int kD, bool kBias, bool kGate, bool kDrop, bool kMask>
cudaError_t launch_kernel(const Maps& maps, const Args& a, dim3 grid, cudaStream_t s) {
    auto kernel = flash_bwd_kernel<kD, kBias, kGate, kDrop, kMask>;
    constexpr size_t smem = Plan<kD>::kSmemBytes;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, Plan<kD>::kThreads, smem, s>>>(maps, a);
    return cudaGetLastError();
}

template <int kD, bool kBias, bool kGate>
cudaError_t launch_drop(const Maps& maps, const Args& a, dim3 grid, cudaStream_t s) {
    if (a.seed != nullptr)
        return a.amask != nullptr ? launch_kernel<kD, kBias, kGate, true, true>(maps, a, grid, s)
                                  : launch_kernel<kD, kBias, kGate, true, false>(maps, a, grid, s);
    return a.amask != nullptr ? launch_kernel<kD, kBias, kGate, false, true>(maps, a, grid, s)
                              : launch_kernel<kD, kBias, kGate, false, false>(maps, a, grid, s);
}

template <int kD>
cudaError_t launch_width(const Maps& maps, const Args& a, int B, cudaStream_t s) {
    const dim3 grid(a.n_kt, a.H, B);
    if (a.bias == nullptr) return launch_drop<kD, false, false>(maps, a, grid, s);
    if (a.dgate == nullptr) return launch_drop<kD, true, false>(maps, a, grid, s);
    return launch_drop<kD, true, true>(maps, a, grid, s);
}

}  // namespace

// hd a multiple of 8 up to 128; bias (H, T, S) with row stride bias_rs (a
// multiple of 8); dq (B, T, H, hd), dgate (B * H, ceil(T/64) * 64) and
// dbias (H, T, ceil(S/64) * 64) zeroed fp32 buffers; rows (B * H,
// ceil(T/64), 3, 64) fp32 scratch
extern "C" int usk_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out, const void* dout,
    const void* lse, long long q_bs, long long q_rs, long long k_bs, long long k_rs,
    long long v_bs, long long v_rs, long long o_bs, long long o_rs, long long do_bs,
    long long do_rs, const void* bias, long long bias_rs, const void* gate, const void* kpm,
    const void* amask, void* dq, void* dk, void* dv, void* dgate, void* dbias, int B, int T,
    int S, int H, int hd, float scale, void* rows, unsigned threshold, float drop_scale,
    const void* seed, void* stream) {
    if (hd < 8 || hd > kMaxHd || hd % 8 != 0) return (int)cudaErrorInvalidValue;
    const int n_kt = (S + kBKey - 1) / kBKey;
    Maps maps;
    if (!head_map(&maps.q, q, B, T, H, hd, q_bs, q_rs) ||
        !head_map(&maps.k, k, B, S, H, hd, k_bs, k_rs) ||
        !head_map(&maps.v, v, B, S, H, hd, v_bs, v_rs) ||
        !head_map(&maps.dout, dout, B, T, H, hd, do_bs, do_rs))
        return (int)cudaErrorInvalidValue;
    if (bias != nullptr) {
        const uint64_t dims[3] = {(uint64_t)S, (uint64_t)T, (uint64_t)H};
        const uint64_t strides[2] = {(uint64_t)bias_rs * 2, (uint64_t)bias_rs * T * 2};
        const uint32_t box[3] = {kBKey, kBQ, 1};
        if (!usk::make_tensor_map(&maps.bias, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, bias, dims,
                                  strides, box, CU_TENSOR_MAP_SWIZZLE_128B))
            return (int)cudaErrorInvalidValue;
        const uint64_t gdims[3] = {(uint64_t)n_kt * kBKey, (uint64_t)T, (uint64_t)H};
        const uint64_t gstrides[2] = {(uint64_t)n_kt * kBKey * 4, (uint64_t)n_kt * kBKey * T * 4};
        const uint32_t gbox[3] = {32, kBQ, 1};
        if (!usk::make_tensor_map(&maps.dbias, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, dbias, gdims,
                                  gstrides, gbox, CU_TENSOR_MAP_SWIZZLE_128B))
            return (int)cudaErrorInvalidValue;
    } else {
        maps.bias = maps.q;  // unused
        maps.dbias = maps.q;
    }
    const uint64_t qdims[4] = {(uint64_t)hd, (uint64_t)H, (uint64_t)T, (uint64_t)B};
    const uint64_t qstrides[3] = {(uint64_t)hd * 4, (uint64_t)H * hd * 4,
                                  (uint64_t)T * H * hd * 4};
    const uint32_t qbox[4] = {32, 1, kBQ, 1};
    if (!usk::make_tensor_map(&maps.dq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, dq, qdims, qstrides,
                              qbox, CU_TENSOR_MAP_SWIZZLE_128B))
        return (int)cudaErrorInvalidValue;
    Args a;
    a.out = (const __nv_bfloat16*)out;
    a.dout = (const __nv_bfloat16*)dout;
    a.lse = (const float*)lse;
    a.o_bs = o_bs; a.o_rs = o_rs; a.do_bs = do_bs; a.do_rs = do_rs;
    a.bias = (const __nv_bfloat16*)bias;
    a.gate = (const float*)gate;
    a.kpm = (const uint8_t*)kpm;
    a.amask = (const float*)amask;
    a.rows = (float*)rows;
    a.dq = (float*)dq;
    a.dk = (__nv_bfloat16*)dk;
    a.dv = (__nv_bfloat16*)dv;
    a.dgate = (float*)dgate;
    a.dbias = (float*)dbias;
    a.seed = (const long long*)seed;
    a.threshold = threshold;
    a.drop_scale = drop_scale;
    a.T = T; a.S = S; a.H = H; a.hd = hd;
    a.n_qt = (T + kBQ - 1) / kBQ;
    a.n_kt = n_kt;
    a.scale = scale;
    cudaStream_t s = (cudaStream_t)stream;
    const int total = B * H * a.n_qt * kBQ;
    rows_kernel<<<(total + 31) / 32, 256, 0, s>>>(a, total);
    if (hd <= 64) return (int)launch_width<64>(maps, a, B, s);
    return (int)launch_width<128>(maps, a, B, s);
}
