// The fp32 attention forward's width-128 form (hd 104-128, XLS-R 2B's 120
// among them): flash_fwd_f32_wide_kernel, which the entry of
// flash_attention_f32.cu launches for those head dims. It replaces the same
// TPU kernels (unispeech_tpu/ops/pallas/flash_attention.py::_fwd_kernel and
// ::_fwd_kernel_packed) and computes what that file's head says: the logits
// in the plain version's order (x = s q.k + g b + mask), a padded key at
// kPadNeg and a key past S at -inf, the undropped row sum and lse, the
// Philox keep bits of (seed, b, h, t, s), out divided by the row sum at the
// end; one launch per call. A translation unit of its own so that nvcc
// builds it beside the other widths.
//
// Bound on the H100: operations. At fp32 CTC fine-tuning at XLS-R 2B's
// width (4 x 799 frames, 799/599/349/149 valid, 16 heads of 120, key
// padding, no bias) the valid keys ask 4 H T keys hd = 11.63 GFLOP, three
// TF32 products each: 34.9 GFLOP, 70.5 us at 495 TFLOP/s; the bytes (q, k,
// v read, out written, 98 MB) take 29 us.
// What held the first width-128 form (the kD = 128 instance of
// flash_attention_f32.cu's kernel until this file) and what this form does
// instead:
//  - every key tile ran: here the all-padded key tiles are skipped, as the
//    width-80 / width-96 form (flash_attention_f32_mid.cu, whose head
//    proves it exact) skips them: a bit per key tile from the row's key
//    mask, which need not be a suffix; a row of length 0 and any call with
//    a (T, S) mask run every tile. 32 of 52 tiles at the padded batch above;
//  - K and V were loaded and split between two barriers while the tensor
//    cores idled: here one raw fp32 buffer of 32 KB carries the next open
//    tile's K (copied by cp.async while this tile's S runs, split into the
//    one K stage while P.V's first pass runs) and then its V (copied while
//    P.V runs, split into the V^T stage after it). Each thread splits the
//    16-byte units it copied, and its K and V units take the same slots of
//    the buffer, so no barrier waits for a copy and no thread overwrites a
//    unit another thread has yet to split;
//  - one warpgroup of 64 queries per block, one warp per scheduler: here
//    two (128 queries) share each tile's K and V. q stays in fp32 (64 KB,
//    the 128-byte swizzle) and reaches S as wgmma's A operand from
//    registers: each thread loads its fragment of k step kk (4 values, the
//    32 lanes on 32 banks) and splits it while step kk - 1's products run,
//    as the backward's width-80 form (flash_attention_bwd_f32_mid.cu) does
//    with K and V. q, the split K and V^T tiles (64 KB each) and the buffer
//    take 224 KB, one block per SM. (One warpgroup with q split once into
//    hi and lo tiles fits the same 224 KB and ran slower, PERF.md section 6);
//  - each S k step waited for its own products: S's fresh fp32 sum per 8
//    columns stays (the -1e4 mask's rounding needs it,
//    flash_attention_f32.cu's head), in two accumulators in turn, k step
//    kk's products running while step kk - 1's are added;
//  - P.V in two m64n64k8 passes, each into a fresh 32-register accumulator
//    added to O by one fp32 add (one m64n128k8 chain into 64 ran slower).
// At hd 120 the 16 S k steps over the width issue 6% more products than hd
// needs (the columns past hd are zeros).
// The rest is the width-80 / width-96 form's (the per-step pieces of
// flash_attention_f32.cuh): the bias and the keep bits while the first
// products run, the logits and the online softmax in fp32, P split in
// registers into the A fragments of P.V with V^T's keys in P's k order.

#include "flash_attention_f32.cuh"

namespace usk_attn_fwd_f32 {

// the width-128 kernel's shared memory, from a 1024-byte aligned base: q
// [query][column] in fp32, 4 atom columns of 32; the split tiles (hi, lo
// each) of K [key][column] in 4 atom columns and of V^T [column][key] (two
// atom columns of 32 keys, 128 rows each); the raw buffer of the next
// tile's K, then its V, by thread slot (below); the tile's key mask; the
// open-tile bits
struct WideLayout {
    static constexpr int kD = kMaxHd;
    static constexpr int kWG = 2;  // warpgroups of 64 queries
    static constexpr int kThreads = 128 * kWG;
    static constexpr int kBQ = 64 * kWG;
    static constexpr uint32_t kQTile = kBQ * kD * 4;
    static constexpr uint32_t kKTile = kBKey * kD * 4;
    static constexpr uint32_t kVTile = kD * kBKey * 4;
    static constexpr uint32_t kOffK = kQTile;
    static constexpr uint32_t kOffV = kOffK + 2 * kKTile;
    static constexpr uint32_t kOffRaw = kOffV + 2 * kVTile;
    static constexpr uint32_t kOffCol = kOffRaw + kBKey * kD * 4;
    static constexpr uint32_t kOffTiles = kOffCol + kBKey * 4;
    static constexpr int kSmem = (int)(kOffTiles + kTileWords * 4) + 1024;
    // 16-byte units per thread: q and K a row's 4 columns, V 4 keys x 4
    // columns (4 slots each); K's and V's fill the same kSlots slots
    static constexpr int kUnitsQ = kBQ * (kD / 4) / kThreads;
    static constexpr int kUnitsK = kBKey * (kD / 4) / kThreads;
    static constexpr int kItersV = (kBKey / 4) * (kD / 4) / kThreads;
    static constexpr int kSlots = kBKey * kD / 4 / kThreads;
    static_assert(kSmem <= kSmemMax, "the width-128 layout fits a block");
    static_assert(kUnitsK == kSlots && 4 * kItersV == kSlots,
                  "K's and V's units fill the thread's slots of the raw buffer");
};

template <bool kBias, bool kDrop>
__global__ void __launch_bounds__(WideLayout::kThreads, 1) flash_fwd_f32_wide_kernel(Args a) {
    using L = WideLayout;
    constexpr int kD = L::kD;
    extern __shared__ unsigned char attn_f32_wide_raw[];
    unsigned char* sm = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(attn_f32_wide_raw) + 1023) & ~uintptr_t(1023));
    unsigned char* Q = sm;
    unsigned char *Kh = sm + L::kOffK, *Kl = Kh + L::kKTile;
    unsigned char *Vh = sm + L::kOffV, *Vl = Vh + L::kVTile;
    float4* raw = reinterpret_cast<float4*>(sm + L::kOffRaw);
    float* colneg = reinterpret_cast<float*>(sm + L::kOffCol);
    uint32_t* open_bits = reinterpret_cast<uint32_t*>(sm + L::kOffTiles);
    // the tiles' wgmma descriptors; an offset of o bytes adds o >> 4
    const uint64_t dKh = usk::desc_sw128(Kh, 16, 1024), dKl = dKh + (L::kKTile >> 4);
    const uint64_t dVh = usk::desc_sw128(Vh, 16, 1024), dVl = dVh + (L::kVTile >> 4);
    const int hd = a.hd;
    const int tid = threadIdx.x, warp = tid / 32, wg = tid / 128, wq = warp % 4, lane = tid % 32;
    const int g = lane >> 2, tq = lane & 3;
    const int t0 = blockIdx.x * L::kBQ, h = blockIdx.y, b = blockIdx.z;
    const int T = a.T, S = a.S;
    const int n_tiles = (S + kBKey - 1) / kBKey;
    const uint64_t seed = kDrop ? (uint64_t)*a.seed : 0;

    // the key tiles with an open key: a warp reads 32 keys (half a tile) of
    // the row's mask at a time and sets the tile's bit where one is open
    const bool masked = a.kpm != nullptr && a.amask == nullptr;
    if (tid < kTileWords) open_bits[tid] = 0u;
    __syncthreads();
    int row_open = 0;
    if (masked) {
        for (int s1 = 32 * warp; s1 < S; s1 += L::kThreads) {
            const int s = s1 + lane;
            const unsigned open = __ballot_sync(0xffffffffu, s < S && a.kpm[(size_t)b * S + s] == 0);
            const int tile = s1 / kBKey;
            if (open != 0u) {
                row_open = 1;
                if (lane == 0 && tile < 32 * kTileWords) atomicOr(open_bits + (tile >> 5), 1u << (tile & 31));
            }
        }
    }
    // skip only in a row with an open key and without a (T, S) mask
    const bool skip = __syncthreads_or(row_open) != 0;
    auto next_tile = [&](int j) {
        while (skip && j < n_tiles && j < 32 * kTileWords && !((open_bits[j >> 5] >> (j & 31)) & 1u))
            ++j;
        return j;
    };

    // this thread's slots of the raw buffer: raw[kThreads j + tid], j <
    // kSlots. K unit u = tid + kThreads i (key u / (kD / 4), columns
    // 4 (u % (kD / 4))) in slot i; V unit u = tid + kThreads i (keys
    // 8 j + p + 2 m, m = 0..3, (j, p) = u % 16, columns 4 (u / 16)), key m
    // in slot kItersV m + i. Copied by cp.async, zeros for keys past S and
    // columns past hd; the key mask of key s0 + tid into a register
    // (tid < 64) with the tile's K
    auto slot = [&](int j) { return raw + L::kThreads * j + tid; };
    float pmask = 0.f;
    auto issue_k = [&](int s0) {
#pragma unroll
        for (int i = 0; i < L::kUnitsK; ++i) {
            const int u = tid + i * L::kThreads, r = u / (kD / 4), c = 4 * (u % (kD / 4));
            const bool ok = s0 + r < S && c < hd;
            usk::cp_async16(slot(i), ok ? a.k + b * a.k_bs + (s0 + r) * a.k_rs + (long long)h * hd + c : a.k,
                            ok);
        }
        usk::cp_async_commit();
        if (tid < kBKey) {
            const int s = s0 + tid;
            pmask = s >= S ? -INFINITY
                           : ((a.kpm != nullptr && a.kpm[(size_t)b * S + s] != 0) ? kPadNeg : 0.f);
        }
    };
    auto issue_v = [&](int s0) {
#pragma unroll
        for (int i = 0; i < L::kItersV; ++i) {
            const int u = tid + i * L::kThreads, jp = u % 16, c = 4 * (u / 16);
#pragma unroll
            for (int m = 0; m < 4; ++m) {
                const int s = s0 + 8 * (jp >> 1) + (jp & 1) + 2 * m;
                const bool ok = s < S && c < hd;
                usk::cp_async16(slot(L::kItersV * m + i),
                                ok ? a.v + b * a.v_bs + s * a.v_rs + (long long)h * hd + c : a.v, ok);
            }
        }
        usk::cp_async_commit();
    };
    // the thread's own units, split into the K tiles, or into the V^T tiles
    // (the keys of each group of 8 in P's k order: V^T column 8 j + 4 p + m
    // holds key 8 j + p + 2 m) with the tile's key mask
    auto split_k = [&]() {
#pragma unroll
        for (int i = 0; i < L::kUnitsK; ++i) {
            const int u = tid + i * L::kThreads, r = u / (kD / 4), c = 4 * (u % (kD / 4));
            store_split(Kh, Kl, usk::sw_tf32(r, c, kBKey), *slot(i));
        }
    };
    auto split_v = [&]() {
#pragma unroll
        for (int i = 0; i < L::kItersV; ++i) {
            const int u = tid + i * L::kThreads;
            const int jp = u % 16, c = 4 * (u / 16), col = 8 * (jp >> 1) + 4 * (jp & 1);
            float4 x[4];
#pragma unroll
            for (int m = 0; m < 4; ++m) x[m] = *slot(L::kItersV * m + i);
            store_split(Vh, Vl, usk::sw_tf32(c, col, kD), make_float4(x[0].x, x[1].x, x[2].x, x[3].x));
            store_split(Vh, Vl, usk::sw_tf32(c + 1, col, kD), make_float4(x[0].y, x[1].y, x[2].y, x[3].y));
            store_split(Vh, Vl, usk::sw_tf32(c + 2, col, kD), make_float4(x[0].z, x[1].z, x[2].z, x[3].z));
            store_split(Vh, Vl, usk::sw_tf32(c + 3, col, kD), make_float4(x[0].w, x[1].w, x[2].w, x[3].w));
        }
        if (tid < kBKey) colneg[tid] = pmask;
    };

    // the first open tile's K in flight while q is loaded and stored in
    // fp32, then its V; the next open tile's K in flight over the first S
    int cur = next_tile(0);
    if (cur < n_tiles) issue_k(cur * kBKey);
    {
        float4 x[L::kUnitsQ];
#pragma unroll
        for (int i = 0; i < L::kUnitsQ; ++i) {
            const int u = tid + i * L::kThreads, r = u / (kD / 4), c = 4 * (u % (kD / 4));
            x[i] = (t0 + r < T && c < hd)
                       ? __ldg(reinterpret_cast<const float4*>(a.q + b * a.q_bs + (t0 + r) * a.q_rs +
                                                               (long long)h * hd + c))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int i = 0; i < L::kUnitsQ; ++i) {
            const int u = tid + i * L::kThreads, r = u / (kD / 4), c = 4 * (u % (kD / 4));
            *reinterpret_cast<float4*>(Q + usk::sw_tf32(r, c, L::kBQ)) = x[i];
        }
    }
    if (cur < n_tiles) {
        usk::cp_async_wait<0>();
        split_k();
        issue_v(cur * kBKey);  // into the slots just split
        usk::cp_async_wait<0>();
        split_v();
    }
    int nxt = next_tile(cur + 1);
    if (nxt < n_tiles) issue_k(nxt * kBKey);
    usk::fence_proxy_async();  // the tiles visible to wgmma
    __syncthreads();

    // this thread's query rows: 64 wg + 16 wq + g and + 8 of the block's
    const int rq = 64 * wg + 16 * wq + g;
    int trow[2];
    float gate[2] = {1.f, 1.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        trow[i] = t0 + rq + 8 * i;
        if (kBias && a.gate != nullptr && trow[i] < T)
            gate[i] = a.gate[((size_t)b * a.H + h) * T + trow[i]];
    }
    float o[kD / 2];  // element 4 n + e: row trow[e >> 1], column 8 n + 2 tq + (e & 1)
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
    float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};

    // q's A fragment of k step kk, split in registers (A[g][tq], A[g +
    // 8][tq], A[g][tq + 4], A[g + 8][tq + 4] of the warp's 16 rows)
    const float* qf = reinterpret_cast<const float*>(Q);
    uint32_t qh[2][4], ql[2][4];
    auto load_q = [&](int kk, int bf) {
        const int c = 8 * kk + tq;
        usk::split_tf32(qf[usk::sw_tf32(rq, c, L::kBQ) / 4], qh[bf][0], ql[bf][0]);
        usk::split_tf32(qf[usk::sw_tf32(rq + 8, c, L::kBQ) / 4], qh[bf][1], ql[bf][1]);
        usk::split_tf32(qf[usk::sw_tf32(rq, c + 4, L::kBQ) / 4], qh[bf][2], ql[bf][2]);
        usk::split_tf32(qf[usk::sw_tf32(rq + 8, c + 4, L::kBQ) / 4], qh[bf][3], ql[bf][3]);
    };

    // the next open tile's K from the raw buffer into the K tiles, once every
    // warp's S products are done with them; then its V into the buffer
    auto refill_k = [&]() {
        if (nxt < n_tiles) {
            __syncthreads();
            usk::cp_async_wait<0>();  // this thread's copies of K
            split_k();
            issue_v(nxt * kBKey);  // over this thread's slots, already split
        }
    };

    while (cur < n_tiles) {
        const int s0 = cur * kBKey;

        // S = q.K^T (this warpgroup's 64 queries x 64 keys): each 8-column
        // k step's three products into a fresh accumulator, t[0] and t[1]
        // in turn, added to S by one fp32 add while the next step's
        // products run
        float sacc[32], t[2][32];
        float2 bb[8][2];  // the tile's bias: row i, keys 8 n + 2 tq and + 1
        uint32_t keep = 0xffffffffu;  // bit 4 n + e: element 4 n + e of sacc
        load_q(0, 0);
#pragma unroll
        for (int kk = 0; kk < kD / 8; ++kk) {
            const int bf = kk & 1;
            const uint32_t ok = (kk / 4) * (kBKey * 128) + (kk % 4) * 32;
            const uint64_t dkh = dKh + (ok >> 4);
            usk::wgmma_fence();
            usk::wgmma_m64n64k8_rs_tf32(t[bf], ql[bf], dkh, 0);
            usk::wgmma_m64n64k8_rs_tf32(t[bf], qh[bf], dKl + (ok >> 4), 1);
            usk::wgmma_m64n64k8_rs_tf32(t[bf], qh[bf], dkh, 1);
            usk::wgmma_commit();
            if (kk == 0) {  // while the first products run
                if (kBias) step_bias(a, bb, s0, trow, tq, h);
                if (kDrop) keep = step_keep(a, seed, s0, trow, g, tq, h, b);
            } else {
                usk::wgmma_wait<1>();  // step kk - 1's products
                usk::fence_regs(t[bf ^ 1]);
                usk::fence_regs(qh[bf ^ 1]);
                usk::fence_regs(ql[bf ^ 1]);
#pragma unroll
                for (int i = 0; i < 32; ++i) sacc[i] = kk == 1 ? t[0][i] : sacc[i] + t[bf ^ 1][i];
            }
            if (kk + 1 < kD / 8) load_q(kk + 1, bf ^ 1);  // its buffer is free
        }
        usk::wgmma_wait<0>();
        usk::fence_regs(t[(kD / 8 - 1) & 1]);
#pragma unroll
        for (int bf = 0; bf < 2; ++bf) {
            usk::fence_regs(qh[bf]);
            usk::fence_regs(ql[bf]);
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) sacc[i] += t[(kD / 8 - 1) & 1][i];

        // logits, the online softmax, P split into P.V's A fragments
        float alpha[2];
        uint32_t ph[8][4], pl[8][4];
        step_probs<kBias, kDrop>(a, sacc, bb, gate, trow, colneg, keep, s0, tq, m_r, l_r, alpha,
                                 ph, pl);
#pragma unroll
        for (int i = 0; i < kD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

        // O += P.V, each pass into a fresh accumulator; meanwhile the next
        // open tile's K goes into the K tiles and its V into the raw buffer
#pragma unroll
        for (int hf = 0; hf < kD / 64; ++hf) {
            float ost[32];
            usk::wgmma_fence();
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const uint32_t ov = (j / 4) * (kD * 128) + hf * 64 * 128 + (j % 4) * 32;
                usk::wgmma_m64n64k8_rs_tf32(ost, pl[j], dVh + (ov >> 4), j > 0);
                usk::wgmma_m64n64k8_rs_tf32(ost, ph[j], dVl + (ov >> 4), 1);
                usk::wgmma_m64n64k8_rs_tf32(ost, ph[j], dVh + (ov >> 4), 1);
            }
            usk::wgmma_commit();
            if (hf == 0) refill_k();
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

        cur = nxt;
        if (cur < n_tiles) {
            __syncthreads();          // every warp's P.V is done: the V^T tiles and the key mask are free
            usk::cp_async_wait<0>();  // this thread's copies of V
            split_v();
            nxt = next_tile(cur + 1);
            if (nxt < n_tiles) issue_k(nxt * kBKey);  // over this thread's slots, already split
            usk::fence_proxy_async();
            __syncthreads();  // the K and V^T tiles are complete
        }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
        l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int tr = trow[i];
        if (tr >= T) continue;
        float* dst = a.out + b * a.o_bs + tr * a.o_rs + (long long)h * hd + 2 * tq;
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
            if (8 * n >= hd) break;
            *reinterpret_cast<float2*>(dst + 8 * n) =
                make_float2(o[4 * n + 2 * i] / l_r[i], o[4 * n + 2 * i + 1] / l_r[i]);
        }
        if (a.lse != nullptr && tq == 0)
            a.lse[((size_t)b * a.H + h) * T + tr] = m_r[i] + logf(l_r[i]);
    }
}

template <bool kBias, bool kDrop>
cudaError_t launch_wide_inst(const Args& a, int B, cudaStream_t st) {
    using L = WideLayout;
    auto kernel = flash_fwd_f32_wide_kernel<kBias, kDrop>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.T + L::kBQ - 1) / L::kBQ, a.H, B);
    kernel<<<grid, L::kThreads, L::kSmem, st>>>(a);
    return cudaGetLastError();
}

cudaError_t launch_wide(const Args& a, int B, cudaStream_t st) {
    const bool bias = a.bias != nullptr, drop = a.seed != nullptr;
    if (bias) return drop ? launch_wide_inst<true, true>(a, B, st) : launch_wide_inst<true, false>(a, B, st);
    return drop ? launch_wide_inst<false, true>(a, B, st) : launch_wide_inst<false, false>(a, B, st);
}

}  // namespace usk_attn_fwd_f32
