// Fused attention forward with WavLM's gated relative position bias, in fp32.
//
// Replaces unispeech_tpu/ops/pallas/flash_attention.py::_fwd_kernel
// (head-major layout, launched by _run_forward) and ::_fwd_kernel_packed
// (natural (B, T, H*hd) layout, launched by _run_forward_packed) at fp32,
// the models' default dtype:
//   out = dropout(softmax(q*scale . k^T + gate[b,h,t] * bias[h,t,s]
//                         + attn_mask[t,s] + kPadNeg * (key s padded))) . v
// over the S keys (keys past S, in a tile's tail, take -inf: p = 0) and,
// when asked, lse = max + log(sum) per query row of the undropped
// probabilities, all in fp32. P is not rounded before P.V (the JAX kernel
// rounds it to v's dtype, which in fp32 does nothing). Dropout (kDrop,
// training) multiplies the un-normalised p by keep / (1 - rate) in fp32
// after its row sum is taken, as the bf16 kernel and the TPU kernel do; the
// keep bit of (b, h, t, s) is the Philox function of philox.cuh, so the
// mask is the bf16 kernel's and the plain version's bit for bit.
//
// Bound on the H100: operations. At WavLM-Base+ width and 4 x 16 s (T = 799)
// one call does 7.85 GFLOP and must read q, k, v and the (H, T, S) fp32 bias
// (30.6 MB) and write out: 70 MB, 21 us at 3.35 TB/s. The products run as
// the 3xTF32 split (tf32.cuh) on mma.sync.m16n8k8, three products per
// fragment: 23.6 GFLOP of TF32, 48 us at its 495 TFLOP/s peak.
// Design (the Hopper redesign of the first form, which ran on mma.sync,
// split every fragment in every warp at every use and reached 8-10% of the
// bound; the same kernel on mma.sync with tiles split once ran no faster):
//  - products on wgmma (TF32, m64n64k8, fp32 accumulators in registers) by
//    warpgroups of 64 queries, two per (128-query tile, head, utterance)
//    (195 KB of shared memory, one block per SM). This file holds the width
//    64 (hd <= 64) and the entry; hd 72-96, HuBERT X-Large's 80 among them,
//    run the width-80 / width-96 form of flash_attention_f32_mid.cu, and hd
//    104-128, XLS-R 2B's 120 among them, the width-128 form of
//    flash_attention_f32_wide.cu; their heads say how they differ. TF32
//    wgmma reads shared-memory operands only K-major, in the 128-byte
//    swizzle (hopper.cuh: rows of 32 floats, atoms of 8 rows);
//  - split once: the block's threads split q (once) and K and V (once per
//    64-key step, for all the block's queries) into TF32 hi and lo as they
//    store them into those layouts: q and K as they are (K-major for S =
//    q.K^T), V transposed to V^T (keys along the rows, K-major for P.V)
//    with the keys of each group of 8 in the order P's fragments take them
//    (below). Columns past hd are stored as zeros, so every product runs
//    over the whole padded width kD;
//  - S = q.K^T as three wgmma per 8 columns (q_lo.K_hi, q_hi.K_lo,
//    q_hi.K_hi; the lo.lo term, ~2^-22 relative, dropped) into a fresh
//    64 x 64 accumulator, added to S by one fp32 add per 8 columns, the
//    first form's sums: summed by the tensor cores over all kD columns, S
//    moved by ~1e-6 and a logit behind the -1e4 (T, S) mask (one fp32 ulp
//    1e-3 there) rounded the other way often enough to miss the kernel's
//    max-abs gate; the bias loads, the keep bits and the next stage's
//    loads go out while the first 8 columns' products run;
//  - the logits and online softmax in fp32 in natural units, in the plain
//    version's order (x = s q.k + g b + mask), p = ex2((x - m) log2e); the
//    step's bias is read from device memory into registers while S runs;
//  - P.V with A = P from registers: the wgmma A fragment of a warp takes
//    (row, k t) and (row, k t + 4) where the S accumulator holds keys 2t
//    and 2t + 1, so the k index of each 8-key group is permuted (k t <->
//    key 2t, k t + 4 <-> key 2t + 1) and V^T's keys are stored in that
//    order; P is split in registers (hi, lo), the three products of each
//    8-key group (p_lo.V_hi, p_hi.V_lo, p_hi.V_hi) go into a fresh 64 x 64
//    accumulator per step (per 64 columns of O), which one fp32 add puts
//    into O after the online-softmax rescale: the tensor cores' fp32
//    accumulation truncates, and O sums over all S keys (tf32.cuh);
//  - a ring of two K/V stages: step s + 1's K and V go out into registers
//    while S of step s runs and are split into the other stage while P.V
//    runs, one barrier per step.
// The output is divided by the row sum at the end and stored with 8-byte
// stores. The keep mask (kDrop): one Philox call gives the words of a 2 x 2
// (query, key) block. A lane holds query rows g and g + 8 and the key pairs
// (2 tq, 2 tq + 1) of each 8-key group n; the lane four apart holds rows
// g ^ 1 and g ^ 1 + 8, the other rows of the same blocks. So each lane draws
// the blocks of the groups n whose parity is its row's, keeps its own row's
// bits and swaps the other row's with its partner by one shuffle: 8 Philox
// calls per lane and 64-key step, while S runs. The bits are applied to the
// accumulator elements by their (t, s), before P is permuted into the A
// fragments of P.V.

#include "flash_attention_f32.cuh"

namespace usk_attn_fwd_f32 {
namespace {

// the width-kD kernel's block and shared memory (bytes, from a 1024-byte
// aligned base): q hi and lo, then kBuf stages of K hi, K lo, V^T hi, V^T lo
// and the step's key mask
template <int kD>
struct Plan {
    static_assert(kD == 64, "hd 72-128 run the forms of the _mid.cu and _wide.cu files");
    static constexpr int kWG = 2;  // warpgroups of 64 queries
    static constexpr int kThreads = 128 * kWG;
    static constexpr int kBQ = 64 * kWG;
    static constexpr int kBuf = 2;
    static constexpr uint32_t kQTile = kBQ * kD * 4;
    static constexpr uint32_t kKTile = kBKey * kD * 4;
    static constexpr uint32_t kVTile = kD * kBKey * 4;
    static constexpr uint32_t kStageCol = 2 * kKTile + 2 * kVTile;
    static constexpr uint32_t kStage = kStageCol + 1024;
    static constexpr uint32_t kOffStage = 2 * kQTile;
    static constexpr int kSmemBytes = 1024 + kOffStage + kBuf * kStage;
    // float4 units per thread: q and K one row's 4 columns, V 4 keys x 4 columns
    static constexpr int kUnitsQ = kBQ * (kD / 4) / kThreads;
    static constexpr int kUnitsK = kBKey * (kD / 4) / kThreads;
    static constexpr int kUnitsV = (kBKey / 4) * (kD / 4) / kThreads;
};

template <int kD, bool kDrop>
__global__ void __launch_bounds__(Plan<kD>::kThreads, 1) flash_fwd_f32_kernel(Args a) {
    using P = Plan<kD>;
    extern __shared__ unsigned char attn_f32_raw[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(attn_f32_raw) + 1023) & ~uintptr_t(1023));
    unsigned char* Qh = smem;
    unsigned char* Ql = smem + P::kQTile;
    auto stage = [&](int i) { return smem + P::kOffStage + i * P::kStage; };
    const int hd = a.hd;
    const int tid = threadIdx.x, wg = tid / 128, wq = (tid / 32) % 4, lane = tid % 32;
    const int g = lane >> 2, tq = lane & 3;
    const int t0 = blockIdx.x * P::kBQ, h = blockIdx.y, b = blockIdx.z;
    const int T = a.T, S = a.S;
    const uint64_t seed = kDrop ? (uint64_t)*a.seed : 0;

    // 4 columns c .. c + 3 of row `row` of head h of a (B, rows, H, hd)
    // tensor; zeros for rows past nrows and columns past hd
    auto load4 = [&](const float* src, long long bs, long long rs, int row, int nrows, int c) {
        if (row < nrows && c < hd)
            return __ldg(reinterpret_cast<const float4*>(src + b * bs + row * rs +
                                                         (long long)h * hd + c));
        return make_float4(0.f, 0.f, 0.f, 0.f);
    };
    auto key_mask = [&](int s) {
        if (s >= S) return -INFINITY;
        return (a.kpm != nullptr && a.kpm[(size_t)b * S + s] != 0) ? kPadNeg : 0.f;
    };
    // K unit u: row u / (kD / 4), columns 4 (u % (kD / 4)); V unit u: keys
    // 8 j + p + 2 m (m = 0..3: V^T columns 8 j + 4 p + m, P's k order) at
    // columns 4 c .. 4 c + 3, with (j, p) = u % 16, c = u / 16
    auto k_row = [&](int u) { return u / (kD / 4); };
    auto k_col = [&](int u) { return 4 * (u % (kD / 4)); };
    auto load_v = [&](int s0, int u, float4 (&x)[4]) {
        const int jp = u % 16, c = 4 * (u / 16);
#pragma unroll
        for (int m = 0; m < 4; ++m)
            x[m] = load4(a.v, a.v_bs, a.v_rs, s0 + 8 * (jp >> 1) + (jp & 1) + 2 * m, S, c);
    };
    auto store_v = [&](unsigned char* st, int u, const float4 (&x)[4]) {
        const int jp = u % 16, c = 4 * (u / 16), col = 8 * (jp >> 1) + 4 * (jp & 1);
        store_split(st + 2 * P::kKTile, st + 2 * P::kKTile + P::kVTile, usk::sw_tf32(c, col, kD),
                    make_float4(x[0].x, x[1].x, x[2].x, x[3].x));
        store_split(st + 2 * P::kKTile, st + 2 * P::kKTile + P::kVTile, usk::sw_tf32(c + 1, col, kD),
                    make_float4(x[0].y, x[1].y, x[2].y, x[3].y));
        store_split(st + 2 * P::kKTile, st + 2 * P::kKTile + P::kVTile, usk::sw_tf32(c + 2, col, kD),
                    make_float4(x[0].z, x[1].z, x[2].z, x[3].z));
        store_split(st + 2 * P::kKTile, st + 2 * P::kKTile + P::kVTile, usk::sw_tf32(c + 3, col, kD),
                    make_float4(x[0].w, x[1].w, x[2].w, x[3].w));
    };

    // q, split once for the block
#pragma unroll 4
    for (int i = 0; i < P::kUnitsQ; ++i) {
        const int u = tid + i * P::kThreads, r = u / (kD / 4), c = 4 * (u % (kD / 4));
        store_split(Qh, Ql, usk::sw_tf32(r, c, P::kBQ), load4(a.q, a.q_bs, a.q_rs, t0 + r, T, c));
    }

    // K and V of the step at s0: into registers while S runs, then split
    // into the next stage while P.V runs
    constexpr int kPK = P::kUnitsK, kPV = P::kUnitsV;
    float4 pk[kPK], pv[kPV][4];
    float pmask = 0.f;
    auto load_kv = [&](int s0) {
#pragma unroll
        for (int i = 0; i < kPK; ++i) {
            const int u = tid + i * P::kThreads;
            pk[i] = load4(a.k, a.k_bs, a.k_rs, s0 + k_row(u), S, k_col(u));
        }
#pragma unroll
        for (int i = 0; i < kPV; ++i) load_v(s0, tid + i * P::kThreads, pv[i]);
        if (tid < kBKey) pmask = key_mask(s0 + tid);
    };
    auto store_kv = [&](unsigned char* st) {
#pragma unroll
        for (int i = 0; i < kPK; ++i) {
            const int u = tid + i * P::kThreads;
            store_split(st, st + P::kKTile, usk::sw_tf32(k_row(u), k_col(u), kBKey), pk[i]);
        }
#pragma unroll
        for (int i = 0; i < kPV; ++i) store_v(st, tid + i * P::kThreads, pv[i]);
        if (tid < kBKey) reinterpret_cast<float*>(st + P::kStageCol)[tid] = pmask;
        usk::fence_proxy_async();  // visible to wgmma
    };
    auto direct_kv = [&](int s0, unsigned char* st) {
#pragma unroll 4
        for (int i = 0; i < P::kUnitsK; ++i) {
            const int u = tid + i * P::kThreads;
            store_split(st, st + P::kKTile, usk::sw_tf32(k_row(u), k_col(u), kBKey),
                        load4(a.k, a.k_bs, a.k_rs, s0 + k_row(u), S, k_col(u)));
        }
#pragma unroll 2
        for (int i = 0; i < P::kUnitsV; ++i) {
            float4 x[4];
            load_v(s0, tid + i * P::kThreads, x);
            store_v(st, tid + i * P::kThreads, x);
        }
        if (tid < kBKey) reinterpret_cast<float*>(st + P::kStageCol)[tid] = key_mask(s0 + tid);
        usk::fence_proxy_async();
    };

    // this thread's query rows: 64 wg + 16 wq + g and + 8
    const int r0 = 64 * wg + 16 * wq + g;
    int trow[2];
    float gate[2] = {1.f, 1.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        trow[i] = t0 + r0 + 8 * i;
        if (a.gate != nullptr && trow[i] < T)
            gate[i] = a.gate[((size_t)b * a.H + h) * T + trow[i]];
    }

    float o[kD / 2];  // element 32 hf + 4 n + e: row trow[e >> 1], column 64 hf + 8 n + 2 tq + (e & 1)
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
    float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};

    const int n_steps = (S + kBKey - 1) / kBKey;
    direct_kv(0, stage(0));
    __syncthreads();
    for (int step = 0; step < n_steps; ++step) {
        const int s0 = step * kBKey;
        unsigned char* st = stage(step & 1);
        const unsigned char* Kh = st;
        const unsigned char* Kl = st + P::kKTile;
        const unsigned char* Vh = st + 2 * P::kKTile;
        const unsigned char* Vl = Vh + P::kVTile;
        const float* colneg = reinterpret_cast<const float*>(st + P::kStageCol);

        // S = q.K^T: this warpgroup's 64 queries x 64 keys; each 8-column
        // step's three products into a fresh accumulator t, added to S by
        // one fp32 add (S + a -1e4 mask rounds at 1e-3: S must be fp32 to
        // its last bits)
        float sacc[32];
        float2 bb[8][2];  // the step's bias: row i, keys 8 n + 2 tq and + 1
        uint32_t keep = 0xffffffffu;  // bit 4 n + e: element 4 n + e of sacc
#pragma unroll
        for (int kk = 0; kk < kD / 8; ++kk) {
            const uint32_t oq = (kk / 4) * (P::kBQ * 128) + wg * 64 * 128 + (kk % 4) * 32;
            const uint32_t ok = (kk / 4) * (kBKey * 128) + (kk % 4) * 32;
            const uint64_t dqh = usk::desc_sw128(Qh + oq, 16, 1024);
            const uint64_t dkh = usk::desc_sw128(Kh + ok, 16, 1024);
            float t[32];
            usk::wgmma_fence();
            usk::wgmma_m64n64k8_ss_tf32(t, usk::desc_sw128(Ql + oq, 16, 1024), dkh, 0);
            usk::wgmma_m64n64k8_ss_tf32(t, dqh, usk::desc_sw128(Kl + ok, 16, 1024), 1);
            usk::wgmma_m64n64k8_ss_tf32(t, dqh, dkh, 1);
            usk::wgmma_commit();
            if (kk == 0) {  // while the first products run
                if (step + 1 < n_steps) load_kv(s0 + kBKey);  // in flight over the products
#pragma unroll
                for (int n = 0; n < 8; ++n)
#pragma unroll
                    for (int i = 0; i < 2; ++i) {
                        const int s = s0 + 8 * n + 2 * tq;
                        // s even and rows bias_rs (a multiple of 8, >= S) apart:
                        // the pair lies inside its row
                        bb[n][i] = (a.bias != nullptr && trow[i] < T && s < S)
                                       ? *reinterpret_cast<const float2*>(
                                             a.bias + ((size_t)h * T + trow[i]) * a.bias_rs + s)
                                       : make_float2(0.f, 0.f);
                    }
                if (kDrop) {
                    uint32_t own = 0, other = 0;
#pragma unroll
                    for (int m = 0; m < 4; ++m) {
                        const int n = 2 * m + (g & 1);
#pragma unroll
                        for (int i = 0; i < 2; ++i) {
                            const usk::Philox4 w = usk::philox4x32_10(
                                (uint32_t)((s0 + 8 * n + 2 * tq) >> 1), (uint32_t)(trow[i] >> 1),
                                (uint32_t)h, (uint32_t)b, (uint32_t)seed, (uint32_t)(seed >> 32));
                            // words 0, 1: the even row's keys s, s + 1; 2, 3: the odd row's
                            const uint32_t e0 = (g & 1) ? w.x[2] : w.x[0];
                            const uint32_t e1 = (g & 1) ? w.x[3] : w.x[1];
                            const uint32_t o0 = (g & 1) ? w.x[0] : w.x[2];
                            const uint32_t o1 = (g & 1) ? w.x[1] : w.x[3];
                            const int sh = 4 * n + 2 * i;
                            own |= ((uint32_t)(e0 >= a.threshold) | (uint32_t)(e1 >= a.threshold) << 1)
                                   << sh;
                            other |= ((uint32_t)(o0 >= a.threshold) | (uint32_t)(o1 >= a.threshold) << 1)
                                     << sh;
                        }
                    }
                    keep = own | __shfl_xor_sync(0xffffffffu, other, 4);
                }
            }
            usk::wgmma_wait<0>();
            usk::fence_regs(t);
#pragma unroll
            for (int i = 0; i < 32; ++i) sacc[i] = kk == 0 ? t[i] : sacc[i] + t[i];
        }

        // logits and the online softmax; element 4 n + e of sacc: query row
        // trow[e >> 1], key s0 + 8 n + 2 tq + (e & 1)
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int kl = 8 * n + 2 * tq + (e & 1), s = s0 + kl, i = e >> 1, t = trow[i];
                float x = sacc[4 * n + e] * a.scale;
                if (s < S && t < T) {
                    if (a.bias != nullptr)
                        x = __fadd_rn(x, __fmul_rn(gate[i], (e & 1) ? bb[n][i].y : bb[n][i].x));
                    if (a.amask != nullptr) x = __fadd_rn(x, a.amask[(size_t)t * S + s]);
                }
                x += colneg[kl];  // kPadNeg on a padded key, -inf past S (K's row is 0 there)
                sacc[4 * n + e] = x;
                mx[i] = fmaxf(mx[i], x);
            }
        float alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
            const float m_new = fmaxf(m_r[i], mx[i]);  // finite: key s0 < S
            alpha[i] = usk::ex2((m_r[i] - m_new) * kLog2e);  // 0 on the first step
            m_r[i] = m_new;
            l_r[i] *= alpha[i];
        }
        // P, split into the A fragments of P.V (k index permuted)
        uint32_t ph[8][4], pl[8][4];
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
#pragma unroll
        for (int i = 0; i < kD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

        // O += P.V, 64 columns at a time, each into a fresh accumulator
#pragma unroll
        for (int hf = 0; hf < kD / 64; ++hf) {
            float ost[32];
            usk::wgmma_fence();
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const uint32_t ov = (j / 4) * (kD * 128) + hf * 64 * 128 + (j % 4) * 32;
                const uint64_t dvh = usk::desc_sw128(Vh + ov, 16, 1024);
                usk::wgmma_m64n64k8_rs_tf32(ost, pl[j], dvh, j > 0);
                usk::wgmma_m64n64k8_rs_tf32(ost, ph[j], usk::desc_sw128(Vl + ov, 16, 1024), 1);
                usk::wgmma_m64n64k8_rs_tf32(ost, ph[j], dvh, 1);
            }
            usk::wgmma_commit();
            if (hf == 0 && step + 1 < n_steps) store_kv(stage((step + 1) & 1));
            usk::wgmma_wait<0>();
            usk::fence_regs(ost);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                usk::fence_regs(ph[j]);
                usk::fence_regs(pl[j]);
            }
#pragma unroll
            for (int i = 0; i < 32; ++i) o[32 * hf + i] += ost[i];
        }
        __syncthreads();  // the next stage is complete; this one consumed
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
        l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int t = trow[i];
        if (t >= T) continue;
        float* dst = a.out + b * a.o_bs + t * a.o_rs + (long long)h * hd + 2 * tq;
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
            if (8 * n >= hd) break;
            const int idx = 32 * (n / 8) + 4 * (n % 8) + 2 * i;
            *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(o[idx] / l_r[i], o[idx + 1] / l_r[i]);
        }
        if (a.lse != nullptr && tq == 0)
            a.lse[((size_t)b * a.H + h) * T + t] = m_r[i] + logf(l_r[i]);
    }
}

template <int kD>
cudaError_t launch_width(const Args& a, int B, cudaStream_t st) {
    using P = Plan<kD>;
    auto kernel = a.seed != nullptr ? flash_fwd_f32_kernel<kD, true> : flash_fwd_f32_kernel<kD, false>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmemBytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.T + P::kBQ - 1) / P::kBQ, a.H, B);
    kernel<<<grid, P::kThreads, P::kSmemBytes, st>>>(a);
    return cudaGetLastError();
}

}  // namespace
}  // namespace usk_attn_fwd_f32

// q (B, T, H, hd), k / v (B, S, H, hd) fp32 by (batch, row) strides in
// elements, rows of H hd contiguous floats, every row 16-byte aligned; out
// the same for (B, T, H, hd); bias (H, T, S) fp32 with rows bias_rs apart
// and heads T rows apart, or null; gate (B, H, T) fp32 or null; kpm (B, S)
// bool or null; amask (T, S) fp32 or null; lse (B, H, T) fp32 or null;
// seed a 1-element int64 dropout seed or null (no dropout), threshold and
// drop_scale its keep threshold and 1 / (1 - rate); hd a multiple of 8 up
// to 128: <= 64 runs width 64, 72-80 width 80, 88-96 width 96
// (flash_attention_f32_mid.cu), 104-128 width 128
// (flash_attention_f32_wide.cu)
extern "C" int usk_flash_attention_fwd_f32(
    const void* q, const void* k, const void* v, void* out,
    long long q_bs, long long q_rs, long long k_bs, long long k_rs,
    long long v_bs, long long v_rs, long long o_bs, long long o_rs,
    const void* bias, long long bias_rs, const void* gate, const void* kpm, const void* amask,
    void* lse, int B, int T, int S, int H, int hd, float scale, const void* seed,
    unsigned threshold, float drop_scale, void* stream) {
    using namespace usk_attn_fwd_f32;
    if (hd < 8 || hd > kMaxHd || hd % 8 != 0 || B > 65535 || H > 65535)
        return (int)cudaErrorInvalidValue;
    Args a;
    a.q = (const float*)q;
    a.k = (const float*)k;
    a.v = (const float*)v;
    a.out = (float*)out;
    a.q_bs = q_bs; a.q_rs = q_rs; a.k_bs = k_bs; a.k_rs = k_rs;
    a.v_bs = v_bs; a.v_rs = v_rs; a.o_bs = o_bs; a.o_rs = o_rs;
    a.bias = (const float*)bias;
    a.bias_rs = bias_rs;
    a.gate = (const float*)gate;
    a.kpm = (const uint8_t*)kpm;
    a.amask = (const float*)amask;
    a.lse = (float*)lse;
    a.seed = (const long long*)seed;
    a.threshold = threshold;
    a.drop_scale = drop_scale;
    a.T = T; a.S = S; a.H = H; a.hd = hd;
    a.scale = scale;
    cudaStream_t s = (cudaStream_t)stream;
    if (hd <= 64) return (int)launch_width<64>(a, B, s);
    if (hd <= 80) return (int)launch_mid<80>(a, B, s);
    if (hd <= kMidMaxHd) return (int)launch_mid<96>(a, B, s);
    return (int)launch_wide(a, B, s);
}
