// The fp32 attention backward's width-80 / width-96 form (hd 72-96), the
// flash_bwd_f32_mid_kernel that flash_attention_bwd_f32.cu's launch calls
// for those head dims: see that file's head for what it computes, its bound
// and its design. A translation unit of its own so that nvcc builds it
// beside the other widths.

#include "flash_attention_bwd_f32.cuh"

namespace usk_attn_bwd_f32 {

// the width-80 / width-96 kernel's shared memory, from a 1024-byte aligned
// base: the staging boxes (dq^ one per 32 columns, gate * dS 2), the split
// tiles (hi, lo each): q, dO [query][column] in kAtoms atom columns of 32,
// q^T, dO^T [column][query] (kD rows), dS [query][key]; then K and V in
// fp32 rows of kLd floats (kLd % 32 = 8 or 24: a warp's fragment reads,
// by rows as float2 and by columns as floats, meet no bank twice), the
// next step's q and dO in fp32, and the rows, key mask, dgate sums and bias
// tile as the width-64 kernel
template <int kD>
struct MidLayout {
    static constexpr int kLd = kD + 8;
    static constexpr int kAtoms = (kD + 31) / 32;
    static constexpr uint32_t kQTile = kAtoms * kQS * 128;  // q or dO, hi or lo
    static constexpr uint32_t kQtTile = kD * 128;           // q^T or dO^T, hi or lo
    static constexpr uint32_t kOffGdBox = kAtoms * kBox;
    static constexpr uint32_t kOffQ = kOffGdBox + 2 * kBox;
    static constexpr uint32_t kOffD = kOffQ + 2 * kQTile;
    static constexpr uint32_t kOffQt = kOffD + 2 * kQTile;
    static constexpr uint32_t kOffDt = kOffQt + 2 * kQtTile;
    static constexpr uint32_t kOffS = kOffDt + 2 * kQtTile;
    static constexpr uint32_t kOffK = kOffS + 2 * kTile32;
    static constexpr uint32_t kOffV = kOffK + kBKey * kLd * 4;
    static constexpr uint32_t kOffStage = kOffV + kBKey * kLd * 4;
    static constexpr uint32_t kOffRows = kOffStage + 2 * kQS * kD * 4;
    static constexpr uint32_t kOffCol = kOffRows + 2 * 3 * kQS * 4;
    static constexpr uint32_t kOffDg = kOffCol + kBKey * 4;
    static constexpr uint32_t kOffBias = kOffDg + 4 * kQS * 4;
    static constexpr int kSmem = (int)(kOffBias + kQS * kLdBias * 4) + 1024;
};
constexpr int kSmemMax = 232448;  // a block's shared memory on the H100
static_assert(MidLayout<80>::kSmem <= kSmemMax && MidLayout<96>::kSmem <= kSmemMax,
              "the width-80 / width-96 layout fits a block");

// wgmma TF32, A from registers, N = the mid-width kernel's kD
__device__ __forceinline__ void wgmma_rs_wide(float (&d)[40], const uint32_t (&a)[4], uint64_t db,
                                              int accumulate) {
    usk::wgmma_m64n80k8_rs_tf32(d, a, db, accumulate);
}

__device__ __forceinline__ void wgmma_rs_wide(float (&d)[48], const uint32_t (&a)[4], uint64_t db,
                                              int accumulate) {
    usk::wgmma_m64n96k8_rs_tf32(d, a, db, accumulate);
}

// The width-80 / width-96 kernel (hd 72-96): one warpgroup per (64-key
// tile, head, utterance), 32-query steps, as the width-64 kernel. K and V
// stay unsplit in fp32 and reach the products as wgmma's A operand from
// registers: each k step's fragment is read from shared memory and split
// there (rows of K and V for S^T and dP^T, columns of K for dq^T), a
// double buffer of fragments against the products still reading the last
// one. So no split copy of K, V or K^T takes shared memory (at width 80
// those three alone would take 120 KB). q and dO are split once per step
// into [query][column] tiles whose columns follow the fragments' k order
// (k t <-> column 2 t, k t + 4 <-> 2 t + 1 within each 8, so a lane reads
// its two columns of a row as one float2) and into q^T, dO^T [column]
// [query] tiles with kD rows, which are the N extent of dK and dV
// (m64n80k8 / m64n96k8). dq^T = K^T.dS^T runs as two 64-row passes over
// the columns (the second partly on zero rows: M is 64 per wgmma).
template <int kD, bool kBias, bool kDrop>
__global__ void __launch_bounds__(kThreads64, 1)
    flash_bwd_f32_mid_kernel(const __grid_constant__ Maps maps, const Args a) {
    using L = MidLayout<kD>;
    extern __shared__ unsigned char attn_bwd_f32_raw[];
    unsigned char* sm = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(attn_bwd_f32_raw) + 1023) & ~uintptr_t(1023));
    unsigned char* dq_box = sm;
    unsigned char* gd_box = sm + L::kOffGdBox;
    unsigned char *Qh = sm + L::kOffQ, *Ql = Qh + L::kQTile;
    unsigned char *Dh = sm + L::kOffD, *Dl = Dh + L::kQTile;
    unsigned char *Qth = sm + L::kOffQt, *Qtl = Qth + L::kQtTile;
    unsigned char *Dth = sm + L::kOffDt, *Dtl = Dth + L::kQtTile;
    unsigned char *Sh = sm + L::kOffS, *Sl = Sh + kTile32;
    float* Ks = reinterpret_cast<float*>(sm + L::kOffK);  // [key][kLd], fp32
    float* Vs = reinterpret_cast<float*>(sm + L::kOffV);
    float* stq = reinterpret_cast<float*>(sm + L::kOffStage);  // the next step's q, fp32 [32][kD]
    float* stdo = stq + kQS * kD;                               // and dO
    float* rows = reinterpret_cast<float*>(sm + L::kOffRows);  // [2][lse log2 e, delta, gate][32]
    float* colneg = reinterpret_cast<float*>(sm + L::kOffCol);
    float* dgs = reinterpret_cast<float*>(sm + L::kOffDg);  // [warp][query]
    float* bias_s = reinterpret_cast<float*>(sm + L::kOffBias);
    const uint64_t d0 = usk::desc_sw128(sm, 16, 1024);
    const uint64_t dQh = d0 + (L::kOffQ >> 4), dQl = dQh + (L::kQTile >> 4);
    const uint64_t dDh = d0 + (L::kOffD >> 4), dDl = dDh + (L::kQTile >> 4);
    const uint64_t dQth = d0 + (L::kOffQt >> 4), dQtl = dQth + (L::kQtTile >> 4);
    const uint64_t dDth = d0 + (L::kOffDt >> 4), dDtl = dDth + (L::kQtTile >> 4);
    const uint64_t dSh = d0 + (L::kOffS >> 4), dSl = dSh + (kTile32 >> 4);

    const int hd = a.hd;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, tq = lane & 3;
    const int s0 = blockIdx.x * kBKey, h = blockIdx.y, b = blockIdx.z;
    const int T = a.T, S = a.S;
    const int kl0 = 16 * warp + g;  // this lane's keys (rows of S^T, dP^T, dK, dV): kl0, kl0 + 8
    const int n_steps = (T + kQS - 1) / kQS;
    const uint64_t seed = kDrop ? (uint64_t)*a.seed : 0;
    constexpr int kC4 = kD / 4;  // 4-column units of a row

    // A tile whose keys are all padded, in a row with a key that is not and
    // without a (T, S) mask, adds nothing: its logits carry the -2^100 mask
    // and every query's lse is finite, so p and dS are exactly 0 on it, and
    // its dK and dV rows are 0
    if (a.kpm != nullptr && a.amask == nullptr) {
        int tile_open = 0, row_open = 0;
        for (int s = tid; s < S; s += kThreads64) {
            const int open = a.kpm[(size_t)b * S + s] == 0;
            row_open |= open;
            tile_open |= open & (s >= s0 && s < s0 + kBKey);
        }
        if (__syncthreads_or(row_open) && !__syncthreads_or(tile_open)) {
            for (int u = tid; u < kBKey * (hd / 4); u += kThreads64) {
                const int s = s0 + u / (hd / 4), c = 4 * (u % (hd / 4));
                if (s >= S) break;
                const size_t off = (((size_t)b * S + s) * a.H + h) * hd + c;
                *reinterpret_cast<float4*>(a.dk + off) = make_float4(0.f, 0.f, 0.f, 0.f);
                *reinterpret_cast<float4*>(a.dv + off) = make_float4(0.f, 0.f, 0.f, 0.f);
            }
            return;
        }
    }

    // K and V once, fp32, zeros for keys past S and columns past hd
    for (int u = tid; u < kBKey * kC4; u += kThreads64) {
        const int r = u / kC4, c = 4 * (u % kC4), s = s0 + r;
        const bool ok = s < S && c < hd;
        usk::cp_async16(Ks + r * L::kLd + c,
                        ok ? a.k + b * a.k_bs + s * a.k_rs + (long long)h * hd + c : a.k, ok);
        usk::cp_async16(Vs + r * L::kLd + c,
                        ok ? a.v + b * a.v_bs + s * a.v_rs + (long long)h * hd + c : a.v, ok);
    }
    usk::cp_async_commit();
    if (tid < kBKey) {
        const int s = s0 + tid;
        colneg[tid] = s >= S ? -INFINITY
                             : ((a.kpm != nullptr && a.kpm[(size_t)b * S + s] != 0) ? kPadNeg : 0.f);
    }

    // a step's q and dO: unit u copies queries 8 (qjp >> 1) + (qjp & 1) +
    // 2 m (m = 0..3, qjp = u % 8) at columns qc = 4 (u / 8) by cp.async into
    // the fp32 staging (threads < 24 the step's rows), and the thread that
    // copied them splits them into q, dO (their columns in the fragments'
    // k order) and q^T, dO^T (the queries of each group of 8 in P's k
    // order: columns 8 (qjp >> 1) + 4 (qjp & 1) + m); columns past hd as zeros
    const float* rows_src = a.rows + (size_t)(b * a.H + h) * a.n_qt * kRowFloats;
    auto q_row = [](int qjp, int m) { return 8 * (qjp >> 1) + (qjp & 1) + 2 * m; };
    auto issue_step = [&](int t0, int buf) {
        for (int u = tid; u < 8 * kC4; u += kThreads64) {
            const int qjp = u % 8, qc = 4 * (u / 8);
#pragma unroll
            for (int m = 0; m < 4; ++m) {
                const int r = q_row(qjp, m), t = t0 + r;
                const bool ok = t < T && qc < hd;
                usk::cp_async16(stq + r * kD + qc,
                                ok ? a.q + b * a.q_bs + t * a.q_rs + (long long)h * hd + qc : a.q, ok);
                usk::cp_async16(stdo + r * kD + qc,
                                ok ? a.dout + b * a.do_bs + t * a.do_rs + (long long)h * hd + qc
                                   : a.dout,
                                ok);
            }
        }
        if (tid < 3 * kQS / 4)
            usk::cp_async16(rows + buf * 3 * kQS + 4 * tid,
                            rows_src + (size_t)(t0 / kBQ) * kRowFloats + (tid / 8) * kBQ + t0 % kBQ +
                                4 * (tid % 8),
                            true);
        usk::cp_async_commit();
    };
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
        for (int u = tid; u < 8 * kC4; u += kThreads64) {
            const int qjp = u % 8, qc = 4 * (u / 8);
            // columns qc, qc + 2 and qc + 1, qc + 3 at k positions p0, p0 + 1
            // and p0 + 4, p0 + 5 of their group of 8
            const int p0 = (qc & ~7) + (qc & 4) / 2;
            float4 x[4], y[4];
#pragma unroll
            for (int m = 0; m < 4; ++m) {
                const int r = q_row(qjp, m);
                x[m] = *reinterpret_cast<const float4*>(stq + r * kD + qc);
                y[m] = *reinterpret_cast<const float4*>(stdo + r * kD + qc);
                store_split2(Qh, Ql, usk::sw_tf32(r, p0, kQS), x[m].x, x[m].z);
                store_split2(Qh, Ql, usk::sw_tf32(r, p0 + 4, kQS), x[m].y, x[m].w);
                store_split2(Dh, Dl, usk::sw_tf32(r, p0, kQS), y[m].x, y[m].z);
                store_split2(Dh, Dl, usk::sw_tf32(r, p0 + 4, kQS), y[m].y, y[m].w);
            }
            const int col = 8 * (qjp >> 1) + 4 * (qjp & 1);
            store_split4(Qth, Qtl, usk::sw_tf32(qc, col, kD), make_float4(x[0].x, x[1].x, x[2].x, x[3].x));
            store_split4(Qth, Qtl, usk::sw_tf32(qc + 1, col, kD), make_float4(x[0].y, x[1].y, x[2].y, x[3].y));
            store_split4(Qth, Qtl, usk::sw_tf32(qc + 2, col, kD), make_float4(x[0].z, x[1].z, x[2].z, x[3].z));
            store_split4(Qth, Qtl, usk::sw_tf32(qc + 3, col, kD), make_float4(x[0].w, x[1].w, x[2].w, x[3].w));
            store_split4(Dth, Dtl, usk::sw_tf32(qc, col, kD), make_float4(y[0].x, y[1].x, y[2].x, y[3].x));
            store_split4(Dth, Dtl, usk::sw_tf32(qc + 1, col, kD), make_float4(y[0].y, y[1].y, y[2].y, y[3].y));
            store_split4(Dth, Dtl, usk::sw_tf32(qc + 2, col, kD), make_float4(y[0].z, y[1].z, y[2].z, y[3].z));
            store_split4(Dth, Dtl, usk::sw_tf32(qc + 3, col, kD), make_float4(y[0].w, y[1].w, y[2].w, y[3].w));
        }
    };
    issue_step(0, 0);
    if (kBias) issue_bias(0);
    usk::cp_async_wait<0>();  // K, V and step 0 (this thread's copies: store_step reads its own)
    store_step();
    if (n_steps > 1) issue_step(kQS, 1);
    usk::fence_proxy_async();  // the tiles visible to wgmma
    __syncthreads();

    float dk[kD / 2], dv[kD / 2];  // element 4 n + e: key kl0 + 8 (e >> 1), column 8 n + 2 tq + (e & 1)
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) dk[i] = dv[i] = 0.f;

    for (int it = 0; it < n_steps; ++it) {
        const int t0 = it * kQS;
        const float* rw = rows + (it & 1) * 3 * kQS;

        // S^T = K.q^T and dP^T = V.dO^T (64 keys x 32 queries), A = rows
        // kl0, kl0 + 8 of K and V from registers: k step kk's columns 8 kk +
        // 2 tq (k tq) and + 1 (k tq + 4) as one float2, split in registers
        // while the last step's products run; summed by the tensor cores
        // over kD as the width-64 kernel
        float st[16], dpt[16];
        uint32_t kh[2][4], kl[2][4], vh[2][4], vl[2][4];
        auto load_kv = [&](int kk, int bf) {
            const int c = 8 * kk + 2 * tq;
            const float2 k0 = *reinterpret_cast<const float2*>(Ks + kl0 * L::kLd + c);
            const float2 k1 = *reinterpret_cast<const float2*>(Ks + (kl0 + 8) * L::kLd + c);
            const float2 v0 = *reinterpret_cast<const float2*>(Vs + kl0 * L::kLd + c);
            const float2 v1 = *reinterpret_cast<const float2*>(Vs + (kl0 + 8) * L::kLd + c);
            usk::split_tf32(k0.x, kh[bf][0], kl[bf][0]);
            usk::split_tf32(k1.x, kh[bf][1], kl[bf][1]);
            usk::split_tf32(k0.y, kh[bf][2], kl[bf][2]);
            usk::split_tf32(k1.y, kh[bf][3], kl[bf][3]);
            usk::split_tf32(v0.x, vh[bf][0], vl[bf][0]);
            usk::split_tf32(v1.x, vh[bf][1], vl[bf][1]);
            usk::split_tf32(v0.y, vh[bf][2], vl[bf][2]);
            usk::split_tf32(v1.y, vh[bf][3], vl[bf][3]);
        };
        load_kv(0, 0);
#pragma unroll
        for (int kk = 0; kk < kD / 8; ++kk) {
            const int bf = kk & 1;
            const uint32_t ob = (kk / 4) * (kQS * 128) + (kk % 4) * 32;
            const uint64_t dqh = dQh + (ob >> 4), ddh = dDh + (ob >> 4);
            usk::wgmma_fence();
            usk::wgmma_m64n32k8_rs_tf32(st, kl[bf], dqh, kk > 0);
            usk::wgmma_m64n32k8_rs_tf32(st, kh[bf], dQl + (ob >> 4), 1);
            usk::wgmma_m64n32k8_rs_tf32(st, kh[bf], dqh, 1);
            usk::wgmma_m64n32k8_rs_tf32(dpt, vl[bf], ddh, kk > 0);
            usk::wgmma_m64n32k8_rs_tf32(dpt, vh[bf], dDl + (ob >> 4), 1);
            usk::wgmma_m64n32k8_rs_tf32(dpt, vh[bf], ddh, 1);
            usk::wgmma_commit();
            if (kk + 1 < kD / 8) {
                usk::wgmma_wait<1>();  // step kk - 1's products: their fragments are free
                if (kk > 0) {
                    usk::fence_regs(kh[bf ^ 1]);
                    usk::fence_regs(kl[bf ^ 1]);
                    usk::fence_regs(vh[bf ^ 1]);
                    usk::fence_regs(vl[bf ^ 1]);
                }
                load_kv(kk + 1, bf ^ 1);
            }
        }
        // while the products run: the keep bits
        const uint32_t keep = kDrop ? step_keep(a, seed, s0 + kl0, t0, g, tq, h, b) : 0xffffffffu;
        usk::wgmma_wait<0>();
        usk::fence_regs(st);
        usk::fence_regs(dpt);
#pragma unroll
        for (int bf = 0; bf < 2; ++bf) {
            usk::fence_regs(kh[bf]);
            usk::fence_regs(kl[bf]);
            usk::fence_regs(vh[bf]);
            usk::fence_regs(vl[bf]);
        }

        float dg[4][2];  // dS * bias summed over this lane's keys
        step_probs<kBias, kDrop>(a, st, dpt, dg, keep, rw, bias_s, colneg, kl0, tq, s0, t0);

        // dV += (p c)^T.dO as the width-64 kernel, N = kD; meanwhile dS
        // (query, key) goes split into the dS tile, gate * dS into the
        // dbias staging boxes, and the dgate sums
        {
            uint32_t ph[4][4], pl[4][4];
#pragma unroll
            for (int n = 0; n < 4; ++n) {
                usk::split_tf32(st[4 * n + 0], ph[n][0], pl[n][0]);
                usk::split_tf32(st[4 * n + 2], ph[n][1], pl[n][1]);
                usk::split_tf32(st[4 * n + 1], ph[n][2], pl[n][2]);
                usk::split_tf32(st[4 * n + 3], ph[n][3], pl[n][3]);
            }
            float dvt[kD / 2];
            usk::wgmma_fence();
#pragma unroll
            for (int n = 0; n < 4; ++n) {
                const uint64_t dh = dDth + 2 * n;
                wgmma_rs_wide(dvt, pl[n], dh, n > 0);
                wgmma_rs_wide(dvt, ph[n], dDtl + 2 * n, 1);
                wgmma_rs_wide(dvt, ph[n], dh, 1);
            }
            usk::wgmma_commit();
#pragma unroll
            for (int n = 0; n < 4; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int kl_ = kl0 + 8 * (e >> 1), ql = 8 * n + 2 * tq + (e & 1);
                    const float2 sp = usk::split_pair(dpt[4 * n + e]);
                    const uint32_t off = usk::sw_tf32(ql, kl_, kQS);
                    *reinterpret_cast<float*>(Sh + off) = sp.x;
                    *reinterpret_cast<float*>(Sl + off) = sp.y;
                    if (kBias)
                        *reinterpret_cast<float*>(gd_box + (kl_ >> 5) * kBox + usk::sw_tf32(ql, kl_ & 31, kQS)) =
                            __fmul_rn(rw[2 * kQS + ql], dpt[4 * n + e]);
                }
            usk::fence_proxy_async();  // the dS tile visible to wgmma, the boxes to the TMA unit
            if (kBias && a.dgate != nullptr) {
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
            for (int i = 0; i < kD / 2; ++i) dv[i] += dvt[i];
        }

        // dK += dS^T.q^ as dV, B = q^T
        {
            uint32_t sh_[4][4], sl[4][4];
#pragma unroll
            for (int n = 0; n < 4; ++n) {
                usk::split_tf32(dpt[4 * n + 0], sh_[n][0], sl[n][0]);
                usk::split_tf32(dpt[4 * n + 2], sh_[n][1], sl[n][1]);
                usk::split_tf32(dpt[4 * n + 1], sh_[n][2], sl[n][2]);
                usk::split_tf32(dpt[4 * n + 3], sh_[n][3], sl[n][3]);
            }
            float dkt[kD / 2];
            usk::wgmma_fence();
#pragma unroll
            for (int n = 0; n < 4; ++n) {
                const uint64_t qh = dQth + 2 * n;
                wgmma_rs_wide(dkt, sl[n], qh, n > 0);
                wgmma_rs_wide(dkt, sh_[n], dQtl + 2 * n, 1);
                wgmma_rs_wide(dkt, sh_[n], qh, 1);
            }
            usk::wgmma_commit();
            __syncthreads();  // the dS tile and the dgate sums are complete; the bias tile consumed
            if (kBias && it + 1 < n_steps) issue_bias(t0 + kQS);  // lands before this step ends
            if (kBias && a.dgate != nullptr && tid < kQS && t0 + tid < T)
                atomicAdd(a.dgate + ((size_t)b * a.H + h) * T + t0 + tid,
                          (dgs[tid] + dgs[kQS + tid]) + (dgs[2 * kQS + tid] + dgs[3 * kQS + tid]));
            usk::wgmma_wait<0>();
            usk::fence_regs(dkt);
#pragma unroll
            for (int n = 0; n < 4; ++n) {
                usk::fence_regs(sh_[n]);
                usk::fence_regs(sl[n]);
            }
#pragma unroll
            for (int i = 0; i < kD / 2; ++i) dk[i] += dkt[i];
        }

        // dq^T = K^T.dS^T (columns x 32 queries) over the tile's 64 keys in
        // two passes of 64 columns: A = columns kl0 (+ 8) (+ 64 in the
        // second pass) of K from registers (k t <-> key 8 kk + t), zero on
        // a warp whose 16 columns lie past kD; B = the dS tile
        float dq0[16], dq1[16];  // element 4 n + e: column kl0 + 8 (e >> 1) (+ 64), query 8 n + 2 tq + (e & 1)
        {
            uint32_t th[2][2][4], tl[2][2][4];
            auto load_kt = [&](int kk, int bf) {
                const float* kp = Ks + (8 * kk + tq) * L::kLd + kl0;
#pragma unroll
                for (int p = 0; p < 2; ++p) {
                    if (16 * warp + 64 * p < kD) {
                        usk::split_tf32(kp[64 * p], th[bf][p][0], tl[bf][p][0]);
                        usk::split_tf32(kp[64 * p + 8], th[bf][p][1], tl[bf][p][1]);
                        usk::split_tf32(kp[4 * L::kLd + 64 * p], th[bf][p][2], tl[bf][p][2]);
                        usk::split_tf32(kp[4 * L::kLd + 64 * p + 8], th[bf][p][3], tl[bf][p][3]);
                    } else {
#pragma unroll
                        for (int i = 0; i < 4; ++i) th[bf][p][i] = tl[bf][p][i] = 0u;
                    }
                }
            };
            load_kt(0, 0);
#pragma unroll
            for (int kk = 0; kk < 8; ++kk) {
                const int bf = kk & 1;
                const uint32_t ob = (kk / 4) * (kQS * 128) + (kk % 4) * 32;
                const uint64_t dsh = dSh + (ob >> 4), dsl = dSl + (ob >> 4);
                usk::wgmma_fence();
                usk::wgmma_m64n32k8_rs_tf32(dq0, tl[bf][0], dsh, kk > 0);
                usk::wgmma_m64n32k8_rs_tf32(dq0, th[bf][0], dsl, 1);
                usk::wgmma_m64n32k8_rs_tf32(dq0, th[bf][0], dsh, 1);
                usk::wgmma_m64n32k8_rs_tf32(dq1, tl[bf][1], dsh, kk > 0);
                usk::wgmma_m64n32k8_rs_tf32(dq1, th[bf][1], dsl, 1);
                usk::wgmma_m64n32k8_rs_tf32(dq1, th[bf][1], dsh, 1);
                usk::wgmma_commit();
                if (kk + 1 < 8) {
                    usk::wgmma_wait<1>();
                    if (kk > 0) {
                        usk::fence_regs(th[bf ^ 1][0]);
                        usk::fence_regs(tl[bf ^ 1][0]);
                        usk::fence_regs(th[bf ^ 1][1]);
                        usk::fence_regs(tl[bf ^ 1][1]);
                    }
                    load_kt(kk + 1, bf ^ 1);
                }
            }
            usk::wgmma_wait<0>();
            usk::fence_regs(dq0);
            usk::fence_regs(dq1);
#pragma unroll
            for (int bf = 0; bf < 2; ++bf)
#pragma unroll
                for (int p = 0; p < 2; ++p) {
                    usk::fence_regs(th[bf][p]);
                    usk::fence_regs(tl[bf][p]);
                }
        }
        // dq^ (query, column) into the staging boxes of 32 columns (the
        // second pass's columns 64 .. 32 kAtoms - 1)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int col = kl0 + 8 * (e >> 1), ql = 8 * n + 2 * tq + (e & 1);
                *reinterpret_cast<float*>(dq_box + (col >> 5) * kBox + usk::sw_tf32(ql, col & 31, kQS)) =
                    dq0[4 * n + e];
                if (col + 64 < 32 * L::kAtoms)
                    *reinterpret_cast<float*>(dq_box + 2 * kBox + usk::sw_tf32(ql, col, kQS)) =
                        dq1[4 * n + e];
            }
        usk::cp_async_wait<0>();  // the next step's q, dO, rows and bias (this thread's copies)
        usk::fence_proxy_async();
        __syncthreads();  // the staging boxes are complete; this step's tiles consumed
        if (tid == 0) {
#pragma unroll
            for (int bx = 0; bx < L::kAtoms; ++bx)
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
        for (int n = 0; n < kD / 8; ++n) {
            if (8 * n >= hd) break;
            *reinterpret_cast<float2*>(a.dk + row + 8 * n) =
                make_float2(dk[4 * n + 2 * i] * a.scale, dk[4 * n + 2 * i + 1] * a.scale);
            *reinterpret_cast<float2*>(a.dv + row + 8 * n) =
                make_float2(dv[4 * n + 2 * i], dv[4 * n + 2 * i + 1]);
        }
    }
}

template <int kD, bool kBias, bool kDrop>
cudaError_t launch_mid(const Maps& maps, const Args& a, dim3 grid, cudaStream_t st) {
    auto kernel = flash_bwd_f32_mid_kernel<kD, kBias, kDrop>;
    constexpr int smem = MidLayout<kD>::kSmem;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads64, smem, st>>>(maps, a);
    return cudaGetLastError();
}

template <int kD>
cudaError_t launch_mid_any(const Maps& maps, const Args& a, dim3 grid, cudaStream_t st) {
    const bool bias = a.bias != nullptr, drop = a.seed != nullptr;
    if (bias) return drop ? launch_mid<kD, true, true>(maps, a, grid, st)
                          : launch_mid<kD, true, false>(maps, a, grid, st);
    return drop ? launch_mid<kD, false, true>(maps, a, grid, st)
                : launch_mid<kD, false, false>(maps, a, grid, st);
}

template cudaError_t launch_mid_any<80>(const Maps&, const Args&, dim3, cudaStream_t);
template cudaError_t launch_mid_any<96>(const Maps&, const Args&, dim3, cudaStream_t);

}  // namespace usk_attn_bwd_f32
