// The fp32 attention forward's width-80 / width-96 form (hd 72-96, HuBERT
// X-Large's 80 among them): flash_fwd_f32_mid_kernel, which the entry of
// flash_attention_f32.cu launches for those head dims. It replaces the same
// TPU kernels (unispeech_tpu/ops/pallas/flash_attention.py::_fwd_kernel and
// ::_fwd_kernel_packed) and computes what that file's head says, as its
// width-128 instance computed it for these heads: the logits in the plain
// version's order (x = s q.k + g b + mask), a padded key at kPadNeg and a
// key past S at -inf, the undropped row sum and lse, the Philox keep bits of
// (seed, b, h, t, s), out divided by the row sum at the end; one launch per
// call. A translation unit of its own so that nvcc builds it beside the
// other widths.
//
// Bound on the H100: operations. At HuBERT X-Large fine-tuning's call (4 x
// 799 frames, 799/599/349/149 valid, 16 heads of 80, key padding, no bias)
// the valid keys ask 4 H T keys hd = 7.76 GFLOP, three TF32 products each:
// 23.3 GFLOP, 47 us at 495 TFLOP/s; the bytes (q, k, v read, out written,
// 65 MB) take 19 us.
// What held the width-128 instance at 5% of that bound on these heads, and
// what this form does instead:
//  - products at the width: S = q.K^T takes kD / 8 k steps (10 at kD = 80),
//    never one past the width (the columns from hd to kD are zeros in the
//    tiles), and P.V is one chain of m64nNk8 with N = kD (80 or 96) in
//    place of two m64n64k8 passes. q and K are K-major along the columns in
//    kAtoms = 3 atom columns of 32 floats (the 128-byte swizzle), 96 wide;
//    at kD = 80 the last atom's columns 80-95 are never written or read;
//  - all-padded key tiles skipped: in a batch row with an open key and
//    without a (T, S) mask, a key tile whose keys are all padded adds
//    exactly 0 to O and to the row sum: each of its logits is -2^100 once
//    the mask is added, the running max is finite after the row's first open
//    key, so ex2((x - m) log2e) is 0 and the rescale is by 1; before the
//    first open key such a tile leaves a running sum that the first open
//    tile's rescale by 0 erases. So skipping it leaves O, l and m as they
//    were, in whatever order the open tiles come. The block reads its row's
//    key mask once into a bit per tile (the mask need not be a suffix) and
//    runs the open tiles only; a row of length 0 and any call with a (T, S)
//    mask run every tile (such a row stays uniform over its S keys). The
//    keep bits are keyed on (b, h, t, s), so a kept tile's mask is the same;
//  - loads under the products: each thread copies its units of the next open
//    tile's K and V raw in fp32 by cp.async into a staging buffer while this
//    tile's S and P.V run, and later splits them itself into the one split
//    stage (so no barrier waits for the copy): K while P.V runs (S is done
//    with the K tiles), V after P.V;
//  - two warpgroups of 64 queries per block at kD = 80, sharing each
//    tile's K and V: q (96 KB split), the stage (K 48 KB, V^T 40) and the
//    raw buffer (40) take 226 KB, one block per SM. K and V are split once
//    for 128 queries, and each scheduler holds two warps to hide the
//    softmax's latencies: 1.55x one warpgroup's speed at X-Large's call
//    (bench_attention_forward.py --shape xlarge --dtype fp32, 0.19 against
//    0.30 ms on an H100 at 700 W). At kD = 96 two would take 241 KB, so it
//    runs one (194 KB);
//  - S's fresh fp32 sum per 8 columns (the -1e4 mask's rounding needs it,
//    flash_attention_f32.cu's head) in two accumulators in turn: k step kk's
//    three products run while step kk - 1's are added (wgmma_wait<1>), in
//    place of a full stop per k step (0-4% faster than that with two
//    warpgroups per block, whose other warpgroup's work fills the stop:
//    bench_attention_forward.py --variants, serial_s).
// The rest is the width-64 kernel's: the logits and the online
// softmax in fp32, P split in registers into the A fragments of P.V with
// V^T's keys in P's k order, a fresh accumulator for each tile's P.V added
// to O by one fp32 add, the keep bits drawn while the first products run.

#include "flash_attention_f32.cuh"

namespace usk_attn_fwd_f32 {

constexpr int kWG80 = 2;          // warpgroups of 64 queries per block at kD = 80 (96: one)

// the width-80 / width-96 kernel's shared memory, from a 1024-byte aligned
// base: the split tiles (hi, lo each) of q [query][column] and K
// [key][column] in kAtoms atom columns of 32 and of V^T [column][key] (two
// atom columns of 32 keys, kD rows each); the next tile's K [key][kD] and V
// (by unit, below) in fp32; the tile's key mask; the open-tile bits
template <int kD, int kWG>
struct MidLayout {
    static constexpr int kThreads = 128 * kWG;
    static constexpr int kBQ = 64 * kWG;
    static constexpr int kAtoms = (kD + 31) / 32;
    static constexpr uint32_t kQTile = kAtoms * kBQ * 128;
    static constexpr uint32_t kKTile = kAtoms * kBKey * 128;
    static constexpr uint32_t kVTile = kD * kBKey * 4;
    static constexpr uint32_t kOffK = 2 * kQTile;
    static constexpr uint32_t kOffV = kOffK + 2 * kKTile;
    static constexpr uint32_t kOffRawK = kOffV + 2 * kVTile;
    static constexpr uint32_t kOffRawV = kOffRawK + kBKey * kD * 4;
    static constexpr uint32_t kOffCol = kOffRawV + kBKey * kD * 4;
    static constexpr uint32_t kOffTiles = kOffCol + kBKey * 4;
    static constexpr int kSmem = (int)(kOffTiles + kTileWords * 4) + 1024;
    // 16-byte units: q and K a row's 4 columns (per thread), V 4 keys x 4
    // columns (over the block)
    static constexpr int kUnitsQ = kBQ * (kD / 4) / kThreads;
    static constexpr int kUnitsK = kBKey * (kD / 4) / kThreads;
    static constexpr int kUnitsV = (kBKey / 4) * (kD / 4);
    static constexpr int kItersV = (kUnitsV + kThreads - 1) / kThreads;
};
static_assert(MidLayout<80, kWG80>::kSmem <= kSmemMax && MidLayout<96, 1>::kSmem <= kSmemMax,
              "the width-80 / width-96 layout fits a block");

// O's products: wgmma TF32, A = P from registers, N = kD
__device__ __forceinline__ void wgmma_pv(float (&d)[40], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
    usk::wgmma_m64n80k8_rs_tf32(d, a, db, accumulate);
}

__device__ __forceinline__ void wgmma_pv(float (&d)[48], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
    usk::wgmma_m64n96k8_rs_tf32(d, a, db, accumulate);
}

template <int kD, int kWG, bool kBias, bool kDrop>
__global__ void __launch_bounds__(128 * kWG, 1) flash_fwd_f32_mid_kernel(Args a) {
    using L = MidLayout<kD, kWG>;
    extern __shared__ unsigned char attn_f32_mid_raw[];
    unsigned char* sm = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(attn_f32_mid_raw) + 1023) & ~uintptr_t(1023));
    unsigned char *Qh = sm, *Ql = sm + L::kQTile;
    unsigned char *Kh = sm + L::kOffK, *Kl = Kh + L::kKTile;
    unsigned char *Vh = sm + L::kOffV, *Vl = Vh + L::kVTile;
    float* raw_k = reinterpret_cast<float*>(sm + L::kOffRawK);
    float4* raw_v = reinterpret_cast<float4*>(sm + L::kOffRawV);
    float* colneg = reinterpret_cast<float*>(sm + L::kOffCol);
    uint32_t* open_bits = reinterpret_cast<uint32_t*>(sm + L::kOffTiles);
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

    // this thread's units of a key tile's K and V, copied raw in fp32 by
    // cp.async (zeros for keys past S and columns past hd): K unit u = tid +
    // kThreads i (key u / (kD / 4), columns 4 (u % (kD / 4))) at raw_k + 4 u; V
    // unit u (keys 8 j + p + 2 m, m = 0..3, (j, p) = u % 16, columns
    // 4 (u / 16)) at raw_v[kUnitsV m + u]; the key mask of key s0 + tid into
    // a register (tid < 64)
    float pmask = 0.f;
    auto issue_kv = [&](int s0) {
#pragma unroll
        for (int i = 0; i < L::kUnitsK; ++i) {
            const int u = tid + i * L::kThreads, r = u / (kD / 4), c = 4 * (u % (kD / 4));
            const bool ok = s0 + r < S && c < hd;
            usk::cp_async16(raw_k + 4 * u,
                            ok ? a.k + b * a.k_bs + (s0 + r) * a.k_rs + (long long)h * hd + c : a.k, ok);
        }
#pragma unroll
        for (int i = 0; i < L::kItersV; ++i) {
            const int u = tid + i * L::kThreads;
            if (u < L::kUnitsV) {
                const int jp = u % 16, c = 4 * (u / 16);
#pragma unroll
                for (int m = 0; m < 4; ++m) {
                    const int s = s0 + 8 * (jp >> 1) + (jp & 1) + 2 * m;
                    const bool ok = s < S && c < hd;
                    usk::cp_async16(raw_v + m * L::kUnitsV + u,
                                    ok ? a.v + b * a.v_bs + s * a.v_rs + (long long)h * hd + c : a.v, ok);
                }
            }
        }
        usk::cp_async_commit();
        if (tid < kBKey) {
            const int s = s0 + tid;
            pmask = s >= S ? -INFINITY
                           : ((a.kpm != nullptr && a.kpm[(size_t)b * S + s] != 0) ? kPadNeg : 0.f);
        }
    };
    // the thread's own units, split into the stage's K tiles and its V^T
    // tiles (the keys of each group of 8 in P's k order: V^T column 8 j +
    // 4 p + m holds key 8 j + p + 2 m), and the tile's key mask
    auto split_k = [&]() {
#pragma unroll
        for (int i = 0; i < L::kUnitsK; ++i) {
            const int u = tid + i * L::kThreads, r = u / (kD / 4), c = 4 * (u % (kD / 4));
            store_split(Kh, Kl, usk::sw_tf32(r, c, kBKey), *reinterpret_cast<const float4*>(raw_k + 4 * u));
        }
    };
    auto split_v = [&]() {
#pragma unroll
        for (int i = 0; i < L::kItersV; ++i) {
            const int u = tid + i * L::kThreads;
            if (u < L::kUnitsV) {
                const int jp = u % 16, c = 4 * (u / 16), col = 8 * (jp >> 1) + 4 * (jp & 1);
                float4 x[4];
#pragma unroll
                for (int m = 0; m < 4; ++m) x[m] = raw_v[m * L::kUnitsV + u];
                store_split(Vh, Vl, usk::sw_tf32(c, col, kD), make_float4(x[0].x, x[1].x, x[2].x, x[3].x));
                store_split(Vh, Vl, usk::sw_tf32(c + 1, col, kD), make_float4(x[0].y, x[1].y, x[2].y, x[3].y));
                store_split(Vh, Vl, usk::sw_tf32(c + 2, col, kD), make_float4(x[0].z, x[1].z, x[2].z, x[3].z));
                store_split(Vh, Vl, usk::sw_tf32(c + 3, col, kD), make_float4(x[0].w, x[1].w, x[2].w, x[3].w));
            }
        }
        if (tid < kBKey) colneg[tid] = pmask;
    };

    // the first open tile's K and V in flight while q is loaded and split
    int cur = next_tile(0);
    if (cur < n_tiles) issue_kv(cur * kBKey);
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
            store_split(Qh, Ql, usk::sw_tf32(r, c, L::kBQ), x[i]);
        }
    }
    if (cur < n_tiles) {
        usk::cp_async_wait<0>();
        split_k();
        split_v();
    }
    int nxt = next_tile(cur + 1);
    if (nxt < n_tiles) issue_kv(nxt * kBKey);
    usk::fence_proxy_async();  // the tiles visible to wgmma
    __syncthreads();

    // this thread's query rows: 64 wg + 16 wq + g and + 8
    int trow[2];
    float gate[2] = {1.f, 1.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        trow[i] = t0 + 64 * wg + 16 * wq + g + 8 * i;
        if (kBias && a.gate != nullptr && trow[i] < T)
            gate[i] = a.gate[((size_t)b * a.H + h) * T + trow[i]];
    }
    float o[kD / 2];  // element 4 n + e: row trow[e >> 1], column 8 n + 2 tq + (e & 1)
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
    float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};

    while (cur < n_tiles) {
        const int s0 = cur * kBKey;

        // S = q.K^T (this warpgroup's 64 queries x 64 keys): each 8-column
        // k step's three products into a fresh accumulator, t[0] and t[1]
        // in turn, added to S by one fp32 add while the next step's
        // products run
        float sacc[32], t[2][32];
        float2 bb[8][2];  // the tile's bias: row i, keys 8 n + 2 tq and + 1
        uint32_t keep = 0xffffffffu;  // bit 4 n + e: element 4 n + e of sacc
#pragma unroll
        for (int kk = 0; kk < kD / 8; ++kk) {
            const uint32_t oq = (kk / 4) * (L::kBQ * 128) + wg * 64 * 128 + (kk % 4) * 32;
            const uint32_t ok = (kk / 4) * (kBKey * 128) + (kk % 4) * 32;
            const uint64_t dqh = usk::desc_sw128(Qh + oq, 16, 1024);
            const uint64_t dkh = usk::desc_sw128(Kh + ok, 16, 1024);
            usk::wgmma_fence();
            usk::wgmma_m64n64k8_ss_tf32(t[kk & 1], usk::desc_sw128(Ql + oq, 16, 1024), dkh, 0);
            usk::wgmma_m64n64k8_ss_tf32(t[kk & 1], dqh, usk::desc_sw128(Kl + ok, 16, 1024), 1);
            usk::wgmma_m64n64k8_ss_tf32(t[kk & 1], dqh, dkh, 1);
            usk::wgmma_commit();
            if (kk == 0) {  // while the first products run
                if (kBias) step_bias(a, bb, s0, trow, tq, h);
                if (kDrop) keep = step_keep(a, seed, s0, trow, g, tq, h, b);
            } else {
                usk::wgmma_wait<1>();  // step kk - 1's products
                usk::fence_regs(t[(kk - 1) & 1]);
#pragma unroll
                for (int i = 0; i < 32; ++i)
                    sacc[i] = kk == 1 ? t[0][i] : sacc[i] + t[(kk - 1) & 1][i];
            }
        }
        usk::wgmma_wait<0>();
        usk::fence_regs(t[(kD / 8 - 1) & 1]);
#pragma unroll
        for (int i = 0; i < 32; ++i) sacc[i] += t[(kD / 8 - 1) & 1][i];

        // logits, the online softmax, P split into P.V's A fragments
        float alpha[2];
        uint32_t ph[8][4], pl[8][4];
        step_probs<kBias, kDrop>(a, sacc, bb, gate, trow, colneg, keep, s0, tq, m_r, l_r, alpha,
                                 ph, pl);
#pragma unroll
        for (int i = 0; i < kD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

        // O += P.V, all kD columns in one chain into a fresh accumulator;
        // meanwhile the next open tile's K goes into the stage
        float ost[kD / 2];
        usk::wgmma_fence();
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const uint32_t ov = (j / 4) * (kD * 128) + (j % 4) * 32;
            const uint64_t dvh = usk::desc_sw128(Vh + ov, 16, 1024);
            wgmma_pv(ost, pl[j], dvh, j > 0);
            wgmma_pv(ost, ph[j], usk::desc_sw128(Vl + ov, 16, 1024), 1);
            wgmma_pv(ost, ph[j], dvh, 1);
        }
        usk::wgmma_commit();
        if (nxt < n_tiles) {
            __syncthreads();          // every warp's S products are done: the K tiles are free
            usk::cp_async_wait<0>();  // this thread's copies of the next tile
            split_k();
        }
        usk::wgmma_wait<0>();
        usk::fence_regs(ost);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            usk::fence_regs(ph[j]);
            usk::fence_regs(pl[j]);
        }
#pragma unroll
        for (int i = 0; i < kD / 2; ++i) o[i] += ost[i];

        cur = nxt;
        if (cur < n_tiles) {
            __syncthreads();  // every warp's P.V is done: the V^T tiles and the key mask are free
            split_v();
            nxt = next_tile(cur + 1);
            if (nxt < n_tiles) issue_kv(nxt * kBKey);  // over this thread's units, already split
            usk::fence_proxy_async();
            __syncthreads();  // the stage is complete
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

template <int kD, bool kBias, bool kDrop>
cudaError_t launch_mid_inst(const Args& a, int B, cudaStream_t st) {
    constexpr int wg = kD == 80 ? kWG80 : 1;
    using L = MidLayout<kD, wg>;
    auto kernel = flash_fwd_f32_mid_kernel<kD, wg, kBias, kDrop>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.T + L::kBQ - 1) / L::kBQ, a.H, B);
    kernel<<<grid, L::kThreads, L::kSmem, st>>>(a);
    return cudaGetLastError();
}

template <int kD>
cudaError_t launch_mid(const Args& a, int B, cudaStream_t st) {
    const bool bias = a.bias != nullptr, drop = a.seed != nullptr;
    if (bias) return drop ? launch_mid_inst<kD, true, true>(a, B, st)
                          : launch_mid_inst<kD, true, false>(a, B, st);
    return drop ? launch_mid_inst<kD, false, true>(a, B, st)
                : launch_mid_inst<kD, false, false>(a, B, st);
}

template cudaError_t launch_mid<80>(const Args&, int, cudaStream_t);
template cudaError_t launch_mid<96>(const Args&, int, cudaStream_t);

}  // namespace usk_attn_fwd_f32
