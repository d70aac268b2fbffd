// Fused attention forward with WavLM's gated relative position bias.
//
// Replaces unispeech_tpu/ops/pallas/flash_attention.py::_fwd_kernel
// (head-major layout, launched by _run_forward) and ::_fwd_kernel_packed
// (natural (B, T, H*hd) layout, launched by _run_forward_packed):
//   out = dropout(softmax(q*scale . k^T + gate[b,h,t] * bias[h,t,s]
//                 + attn_mask[t,s] - 1e30 * (key s padded or s >= S))) . v
// and, when asked, lse = max + log(sum) per query row (taken before
// dropout). Neither the logits nor the probabilities reach device memory.
//
// Bound on the H100: bytes. At WavLM-Base+ width and 4 x 16 s (T = 799)
// one call does 7.85 GFLOP (8 us at the bf16 tensor-core peak) but must
// read q, k, v and the (H, T, S) bf16 bias and write out, about 35 MB
// (10.5 us at 3.35 TB/s).
// Design (Hopper), one warpgroup (128 threads) per (64-query tile, head,
// utterance), three blocks per SM (60 KB of shared memory, <= 168
// registers): at T = 799 the 624 blocks of a serving call fill 1.6 waves
// of 396 resident blocks, at T = 768 the 864 of a training call 2.2; two
// warpgroups of 64 queries per block would share K/V loads (which L2
// serves anyway) at the price of half the blocks in flight.
//  - loads by TMA, issued by one thread: q once, then per 64-key step the
//    K, V and bias tiles (128-byte swizzled 64 x 64 boxes) into a 2-stage
//    ring on mbarriers; q, k and v go through one 4-D map shape over
//    (hd, H, rows, B) by the wrapper's strides, so the packed and the
//    head-major layouts (and q/k/v views of one fused projection) are one
//    kernel; rows past T or S load as zeros. The bias is read through a
//    (S, T, H) map whose rows are padded to whole 16-byte units by its
//    producer (ops/rel_pos.py), so no copy runs per call. The key mask of
//    a step (-1e30 for padded keys and keys past S) is loaded a step
//    ahead into the ring; the gates are read once into registers;
//  - products on wgmma with fp32 accumulators in registers: S = q.K^T by
//    wgmma.m64n64k16 with both operands K-major from shared memory, and
//    O += P.V by wgmma.m64n64k16 with P (bf16) converted in place from the
//    S accumulators as the register A operand and V read MN-major;
//  - online softmax in fp32: the logits x = s q.k + g b + mask and their
//    row max m stay in natural units, in the plain version's order (so lse
//    = m + log l matches it to fp32 rounding), and p = ex2(x log2e - m
//    log2e) is one FMA and one ex2; the q scale is a power of two (hd =
//    64: 1/8), so it multiplies the fp32 products instead of rounding a
//    scaled copy of q;
//  - bias, gate, key padding, the (T, S) mask and dropout are template
//    flags, so the per-element block is straight-line code. The wrappers
//    reach 24 instantiations: {none, bias, bias + gate} x key padding x
//    mask x dropout (serving: bias + gate + key padding; pretraining: bias
//    + gate + dropout).
// Dropout (training): the un-normalised P is multiplied by keep/(1 - rate)
// after its row sum is taken, as the TPU kernel does. The keep bit of each
// (b, h, t, s) comes from Philox-4x32-10 keyed by the 64-bit seed (read
// from device memory: no host sync to draw it) and counted by the absolute
// coordinates (philox.cuh), so the backward kernel and the plain version
// regenerate the identical mask. One Philox call gives the words of a
// 2 x 2 (query, key) block; the two lanes that hold its two query rows
// each compute half of their calls and swap the other lane's words by a
// shuffle, while S = q.K^T runs on the tensor cores.

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"
#include "philox.cuh"

namespace {

constexpr int kHd = 64;    // head dim
constexpr int kBQ = 64;    // queries per block
constexpr int kBKey = 64;  // keys per step
constexpr int kThreads = 128;
constexpr int kStages = 2;
constexpr int kMinBlocks = 3;
constexpr uint32_t kTile = 64 * 128;  // 64 rows of 64 bf16, 128-byte swizzled
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;

// shared memory, from a 1024-byte aligned base: q, then per stage K, V,
// the bias tile and the step's key mask
constexpr uint32_t kOffStage = kTile;
constexpr uint32_t kStageK = 0, kStageV = kTile, kStageB = 2 * kTile, kStageCol = 3 * kTile;
constexpr uint32_t kStageBytes = 3 * kTile + 1024;
constexpr uint32_t kOffBar = kOffStage + kStages * kStageBytes;  // q, full[kStages]
constexpr size_t kSmemBytes = 1024 + kOffBar + 8 * (1 + kStages);

struct Maps {
    CUtensorMap q, k, v;  // (B, rows, H, 64) by strides: dims {64, H, rows, B}
    CUtensorMap bias;     // (H, T, S) with row stride bias_rs: dims {S, T, H}
};

struct Args {
    __nv_bfloat16* out;
    long long o_bs, o_rs;  // elements
    const float* gate;     // (B, H, T) or null (gate 1 with bias)
    const uint8_t* kpm;    // (B, S) 1 = padded key, or null
    const float* amask;    // (T, S) or null
    float* lse;            // (B, H, T) or null
    const long long* seed; // dropout seed (1 element) or null: no dropout
    unsigned threshold;    // keep iff the Philox word >= threshold
    float drop_scale;      // 1 / (1 - rate)
    int T, S, H;
    float scale;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// kBias: a bias tile per key step; kGate: the bias is gated per query;
// kKpm: a (B, S) key padding mask; kMask: an additive (T, S) mask; kDrop:
// dropout on the probabilities
template <bool kBias, bool kGate, bool kKpm, bool kMask, bool kDrop>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    flash_fwd_kernel(const __grid_constant__ Maps maps, const Args a) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    const unsigned char* Qs = smem;
    uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + kOffBar);
    uint64_t* full = q_bar + 1;

    const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int T = a.T, S = a.S, H = a.H;
    const int n_kt = (S + kBKey - 1) / kBKey;
    const int g = lane >> 2, c2 = (lane & 3) * 2;
    const int half = g & 1;  // this lane's query-row parity; lane ^ 4 holds the other row
    const uint64_t seed = kDrop ? (uint64_t)*a.seed : 0;

    auto stage = [&](int st) { return smem + kOffStage + st * kStageBytes; };
    // key tile it's K, V and bias into stage it % kStages (one thread)
    auto issue = [&](int it) {
        unsigned char* sp = stage(it % kStages);
        uint64_t* bar = &full[it % kStages];
        usk::mbar_expect_tx(bar, 2 * kTile + (kBias ? kTile : 0));
        usk::tma_load_4d(sp + kStageK, &maps.k, bar, 0, h, it * kBKey, b);
        usk::tma_load_4d(sp + kStageV, &maps.v, bar, 0, h, it * kBKey, b);
        if (kBias) usk::tma_load_3d(sp + kStageB, &maps.bias, bar, it * kBKey, q0, h);
    };
    // the additive key mask of key tile it for column tid (tid < 64)
    auto key_mask = [&](int it) {
        const int s = it * kBKey + tid;
        bool pad = s >= S;
        if (kKpm && !pad) pad = a.kpm[(size_t)b * S + s] != 0;
        return pad ? kNegInf : 0.f;
    };

    if (tid == 0) {
        usk::mbar_init(q_bar, 1);
        for (int st = 0; st < kStages; ++st) usk::mbar_init(&full[st], 1);
        usk::fence_barrier_init();
    }
    if (tid < kBKey)
        for (int it = 0; it < kStages && it < n_kt; ++it)
            reinterpret_cast<float*>(stage(it) + kStageCol)[tid] = key_mask(it);
    __syncthreads();
    if (tid == 0) {
        usk::mbar_expect_tx(q_bar, kTile);
        usk::tma_load_4d(smem, &maps.q, q_bar, 0, h, q0, b);
        for (int it = 0; it < kStages && it < n_kt; ++it) issue(it);
    }

    // this thread's rows: r_e = warp * 16 + g + 8e of the tile
    float gate[2] = {1.f, 1.f};
    if (kGate) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int t = q0 + warp * 16 + g + 8 * e;
            if (t < T) gate[e] = a.gate[((size_t)b * H + h) * T + t];
        }
    }
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    usk::mbar_wait(q_bar, 0);

    for (int it = 0; it < n_kt; ++it) {
        const int s0 = it * kBKey, st = it % kStages;
        const unsigned char* sp = stage(st);
        const unsigned char* Ks = sp + kStageK;
        const unsigned char* Vs = sp + kStageV;
        const unsigned char* Bs = sp + kStageB;
        const float* colneg = reinterpret_cast<const float*>(sp + kStageCol);
        // every thread is done with tile it - 1: refill its stage with tile
        // it - 1 + kStages; that tile's key mask is loaded now, stored at
        // the end of the step
        __syncthreads();
        const int refill = it - 1 + kStages;
        const bool do_refill = it > 0 && refill < n_kt;
        if (tid == 0 && do_refill) issue(refill);
        float next_mask = 0.f;
        if (do_refill && tid < kBKey) next_mask = key_mask(refill);
        usk::mbar_wait(&full[st], (it / kStages) & 1);

        // S = q.K^T: 64 queries x 64 keys
        float sacc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
        usk::fence_regs(sacc);
        usk::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kHd / 16; ++kk)
            usk::wgmma_m64n64k16_ss<0, 0>(sacc, usk::desc_sw128(Qs + kk * 32, 16, 1024),
                                          usk::desc_sw128(Ks + kk * 32, 16, 1024));
        usk::wgmma_commit();

        // the keep mask while the product runs: bit ((j * 2 + e) * 2 + i)
        // for query row g + 8e and key 8j + c2 + i; this lane computes the
        // calls of the j with j % 2 == half and sends lane ^ 4 its words
        uint32_t keep = 0xffffffffu;
        if (kDrop) {
            keep = 0;
#pragma unroll
            for (int jj = 0; jj < kBKey / 16; ++jj) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int j = 2 * jj + half;
                    const int t = q0 + warp * 16 + g + 8 * e, s = s0 + j * 8 + c2;
                    const usk::Philox4 w = usk::philox4x32_10(
                        (uint32_t)(s >> 1), (uint32_t)(t >> 1), (uint32_t)h, (uint32_t)b,
                        (uint32_t)seed, (uint32_t)(seed >> 32));
                    // word (s & 1) | (t & 1) << 1; s is even, t & 1 == half
                    const uint32_t self0 = half ? w.x[2] : w.x[0], self1 = half ? w.x[3] : w.x[1];
                    const uint32_t oth0 = half ? w.x[0] : w.x[2], oth1 = half ? w.x[1] : w.x[3];
                    const uint32_t mine = (uint32_t)(self0 >= a.threshold) |
                                          ((uint32_t)(self1 >= a.threshold) << 1);
                    const uint32_t other = (uint32_t)(oth0 >= a.threshold) |
                                           ((uint32_t)(oth1 >= a.threshold) << 1);
                    const uint32_t recv = __shfl_xor_sync(0xffffffffu, other, 4);
                    keep |= mine << ((j * 2 + e) * 2);
                    keep |= recv << (((2 * jj + (half ^ 1)) * 2 + e) * 2);
                }
            }
        }
        usk::wgmma_wait<0>();
        usk::fence_regs(sacc);

        // logits and the row maxima; rows g (e = 0) and g + 8
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < kBKey / 8; ++j) {
            const float2 cn = *reinterpret_cast<const float2*>(colneg + j * 8 + c2);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int r = warp * 16 + g + 8 * e;
                float bb[2] = {0.f, 0.f};
                if (kBias) {
                    const __nv_bfloat162 b2 = *reinterpret_cast<const __nv_bfloat162*>(
                        Bs + usk::sw128_offset(r, j * 8 + c2));
                    bb[0] = __low2float(b2);
                    bb[1] = __high2float(b2);
                }
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const int idx = 4 * j + 2 * e + i;
                    float x = sacc[idx] * a.scale;
                    if (kBias) x = fmaf(gate[e], bb[i], x);
                    if (kMask) {
                        const int t = q0 + r, s = s0 + j * 8 + c2 + i;
                        x += (t < T && s < S) ? a.amask[(size_t)t * S + s] : 0.f;
                    }
                    x += i ? cn.y : cn.x;
                    sacc[idx] = x;
                    mx[e] = fmaxf(mx[e], x);
                }
            }
        }
        float alpha[2], ml2[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
            mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
            const float m_new = fmaxf(m[e], mx[e]);
            alpha[e] = usk::ex2((m[e] - m_new) * kLog2e);
            m[e] = m_new;
            ml2[e] = m_new * kLog2e;
        }
#pragma unroll
        for (int j = 0; j < kBKey / 8; ++j) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int e = i >> 1, idx = 4 * j + i;
                const float p = usk::ex2(fmaf(sacc[idx], kLog2e, -ml2[e]));
                rs[e] += p;
                // after the row sum: l is the undropped normaliser
                if (kDrop)
                    sacc[idx] = ((keep >> ((j * 2 + e) * 2 + (i & 1))) & 1) ? p * a.drop_scale : 0.f;
                else
                    sacc[idx] = p;
            }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            rs[e] += __shfl_xor_sync(0xffffffffu, rs[e], 1);
            rs[e] += __shfl_xor_sync(0xffffffffu, rs[e], 2);
            l[e] = l[e] * alpha[e] + rs[e];
        }
#pragma unroll
        for (int j = 0; j < kHd / 8; ++j) {
            o[4 * j] *= alpha[0];
            o[4 * j + 1] *= alpha[0];
            o[4 * j + 2] *= alpha[1];
            o[4 * j + 3] *= alpha[1];
        }

        // O += P.V: P (bf16) from the S accumulators, 16 keys per step
        uint32_t pa[kBKey / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBKey / 16; ++kk) {
            pa[kk][0] = pack_bf16(sacc[8 * kk + 0], sacc[8 * kk + 1]);
            pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
            pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
            pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
        }
        usk::fence_regs(o);
        usk::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBKey / 16; ++kk)
            usk::wgmma_m64n64k16_rs<1>(o, pa[kk], usk::desc_sw128(Vs + kk * 2048, kTile, 1024));
        usk::wgmma_commit();
        usk::wgmma_wait<0>();
        usk::fence_regs(o);
#pragma unroll
        for (int kk = 0; kk < kBKey / 16; ++kk) usk::fence_regs(pa[kk]);
        if (do_refill && tid < kBKey)
            reinterpret_cast<float*>(stage(refill % kStages) + kStageCol)[tid] = next_mask;
    }

    // normalise and store: rows g / g + 8 of this warp's 16, column pairs
    // of each 8-wide slice; lse = m + log l
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        const int t = q0 + warp * 16 + g + 8 * e;
        if (t >= T) continue;
        const float inv = 1.f / l[e];
        __nv_bfloat16* dst = a.out + b * a.o_bs + t * a.o_rs + h * kHd + c2;
#pragma unroll
        for (int j = 0; j < kHd / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
                __floats2bfloat162_rn(o[4 * j + 2 * e] * inv, o[4 * j + 2 * e + 1] * inv);
        if (a.lse != nullptr && c2 == 0)
            a.lse[((size_t)b * H + h) * T + t] = m[e] + logf(l[e]);
    }
}

// (B, rows, H, 64) bf16 by element strides (batch, row) as a 4D map
bool head_map(CUtensorMap* m, const void* p, int B, int rows, int H, long long bs, long long rs) {
    const uint64_t dims[4] = {(uint64_t)kHd, (uint64_t)H, (uint64_t)rows, (uint64_t)B};
    const uint64_t strides[3] = {(uint64_t)kHd * 2, (uint64_t)rs * 2, (uint64_t)bs * 2};
    const uint32_t box[4] = {kHd, 1, 64, 1};
    return usk::make_tensor_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, p, dims, strides, box,
                                CU_TENSOR_MAP_SWIZZLE_128B);
}

template <bool kBias, bool kGate, bool kKpm, bool kMask, bool kDrop>
cudaError_t launch_kernel(const Maps& maps, const Args& a, dim3 grid, cudaStream_t s) {
    auto kernel = flash_fwd_kernel<kBias, kGate, kKpm, kMask, kDrop>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, kSmemBytes, s>>>(maps, a);
    return cudaGetLastError();
}

template <bool kBias, bool kGate>
cudaError_t launch_flags(const Maps& maps, const Args& a, dim3 grid, cudaStream_t s) {
    const int sel = (a.kpm != nullptr ? 4 : 0) | (a.amask != nullptr ? 2 : 0) |
                    (a.seed != nullptr ? 1 : 0);
    switch (sel) {
        case 0: return launch_kernel<kBias, kGate, false, false, false>(maps, a, grid, s);
        case 1: return launch_kernel<kBias, kGate, false, false, true>(maps, a, grid, s);
        case 2: return launch_kernel<kBias, kGate, false, true, false>(maps, a, grid, s);
        case 3: return launch_kernel<kBias, kGate, false, true, true>(maps, a, grid, s);
        case 4: return launch_kernel<kBias, kGate, true, false, false>(maps, a, grid, s);
        case 5: return launch_kernel<kBias, kGate, true, false, true>(maps, a, grid, s);
        case 6: return launch_kernel<kBias, kGate, true, true, false>(maps, a, grid, s);
        default: return launch_kernel<kBias, kGate, true, true, true>(maps, a, grid, s);
    }
}

}  // namespace

// q/k/v/out by element strides (batch, row) in the (B, rows, H*64) layout;
// bias (H, T, S) with row stride bias_rs (a multiple of 8, T * bias_rs
// between heads) or null
extern "C" int usk_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out,
    long long q_bs, long long q_rs, long long k_bs, long long k_rs,
    long long v_bs, long long v_rs, long long o_bs, long long o_rs,
    const void* bias, long long bias_rs, const void* gate, const void* kpm, const void* amask,
    void* lse, int B, int T, int S, int H, float scale, const void* seed,
    unsigned threshold, float drop_scale, void* stream) {
    Maps maps;
    if (!head_map(&maps.q, q, B, T, H, q_bs, q_rs) || !head_map(&maps.k, k, B, S, H, k_bs, k_rs) ||
        !head_map(&maps.v, v, B, S, H, v_bs, v_rs))
        return (int)cudaErrorInvalidValue;
    if (bias != nullptr) {
        const uint64_t dims[3] = {(uint64_t)S, (uint64_t)T, (uint64_t)H};
        const uint64_t strides[2] = {(uint64_t)bias_rs * 2, (uint64_t)bias_rs * T * 2};
        const uint32_t box[3] = {kBKey, kBQ, 1};
        if (!usk::make_tensor_map(&maps.bias, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, bias, dims,
                                  strides, box, CU_TENSOR_MAP_SWIZZLE_128B))
            return (int)cudaErrorInvalidValue;
    } else {
        maps.bias = maps.q;  // unused
    }
    Args a;
    a.out = (__nv_bfloat16*)out;
    a.o_bs = o_bs;
    a.o_rs = o_rs;
    a.gate = (const float*)gate;
    a.kpm = (const uint8_t*)kpm;
    a.amask = (const float*)amask;
    a.lse = (float*)lse;
    a.seed = (const long long*)seed;
    a.threshold = threshold;
    a.drop_scale = drop_scale;
    a.T = T; a.S = S; a.H = H;
    a.scale = scale;
    const dim3 grid((T + kBQ - 1) / kBQ, H, B);
    cudaStream_t s = (cudaStream_t)stream;
    if (bias == nullptr) return (int)launch_flags<false, false>(maps, a, grid, s);
    if (gate == nullptr) return (int)launch_flags<true, false>(maps, a, grid, s);
    return (int)launch_flags<true, true>(maps, a, grid, s);
}
