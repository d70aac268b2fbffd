// Fused conv-frontend block: y = gelu?( conv1d_{k in {2,3}, s=2}( gelu_in?( x*a + b ) ) ).
//
// Replaces unispeech_tpu/ops/pallas/conv_stack.py::_fwd_kernel (launched by
// _run_fwd). When the caller needs gradients it also writes the bf16
// pre-activation ``pre`` (the conv output before the output GELU), the
// residual the backward reads instead of recomputing the product.
//
// Bound on the H100: operations. The block is a GEMM of M = B * t_out rows,
// N = C = 512 output channels and a contraction of k * C over (tap j, input
// channel): output row t reads rows 2t + j of the input. At 4 x 16 s the
// first block alone is 161 GFLOP against a 210 MB input, far above the
// card's ~295 FLOP/byte ridge. Design (Hopper):
//  - the input prologue of the first block (the folded GroupNorm affine,
//    mul then add in fp32, each rounded, then bf16, then the input GELU,
//    then bf16) runs once per element in an elementwise pass, conv_h_kernel,
//    that the backward shares; the block is then a pure GEMM on its output
//    H, as are the other five;
//  - no im2col copy: two TMA tensor maps view the input (B, T, C) as its
//    even rows and its odd rows (row stride 2C); tap 0 of output row t is
//    even row t, tap 1 odd row t, tap 2 even row t + 1, so every tap of a
//    128-row tile is one plain 128 x 64 box; rows past the input load as
//    zeros, and nothing is stored past t_out;
//  - one block per 128 x 128 output tile: a producer warp keeps TMA loads
//    of 64-deep K steps (A 128 x 64 of the input, B 128 x 64 of the weight
//    transposed to (C_out, k * C_in), both 128-byte swizzled) in a 4-stage
//    ring on mbarriers; two consumer warpgroups (setmaxnreg 232) each run
//    wgmma.m64n128k16 on 64 of the rows. Each K step's four products go
//    into a fresh fp32 sum in registers (the first wgmma overwrites it),
//    which one fp32 add per element puts into the running sum once the
//    step's group is done and its stage released. The tensor cores' fp32
//    accumulation truncates: a sum kept in them over all of K = 1536 (as
//    cuBLAS's bf16 GEMM keeps it) rounds pre otherwise than the plain
//    version's fp32 sum in 0.06-0.10% of elements, and that moves the
//    UniSpeech frontend's gradient on padded rows, where LayerNorms of
//    near-zero variance amplify it; with a fresh sum per step 0.016-0.021%
//    (an fp32 GEMM in another order: 0.020-0.032%; probe_w2v_gradient.py
//    --control). A running and a fresh 64 x 128 sum are 128 registers a
//    thread, so a block holds 128 x 128;
//  - the epilogue applies the output GELU (exact erf, fp32) to the
//    accumulators and stores bf16 pairs, and pre when asked.
//
// Backward: replaces ::_bwd_kernel (launched by _run_bwd). With
// g = bf16(gelu'(pre) * dy) and x^ = bf16(x * a + b) (or x), H = bf16(gelu(x^))
// (or x^):
//   dX^[2t + p] = sum over taps p of g[t] . W_p^T      (gather form: input
//       row r = 2t' + par collects taps p = par (+2) from g rows t' - p/2)
//   dX^ *= gelu'(x^) if gelu_in;  da = sum_t dX^ * x, db = sum_t dX^;
//   dx = bf16(dX^ * a), rows >= valid_in zero
//   dW_p = sum_{b, t < t_out} H[b, 2t + p]^T . g[b, t]   (fp32)
// gelu' is the exact erf derivative Phi(x) + x phi(x), not the TPU
// kernel's polynomial. Bound on the H100: operations; at the pretraining
// batch (6 x 245,840 samples) dx and dW of the six blocks are 899 GFLOP,
// 0.909 ms at the bf16 tensor-core peak of 989 TFLOP/s. Design (Hopper),
// in four launches; both GEMMs are a producer warp keeping TMA loads in a
// 4-stage mbarrier ring and two consumer warpgroups on wgmma.m64n256k16
// with 128 fp32 accumulators each under setmaxnreg 232 (128 x 256 tiles,
// one block per SM), except the first block's dx (below). Their sums stay
// in the tensor cores over K: dx and dW are as close to fp64 as the plain
// backward at every block of the UniSpeech frontend
// (probe_w2v_gradient.py):
//   conv_bwd_g_kernel   g (elementwise, 16-byte vectors; skipped without
//                       the output GELU, where g is dy itself)
//   conv_h_kernel       H (elementwise; only with affine or gelu_in, i.e.
//                       the first block of the chain; shared with the forward)
//   conv_bwd_dx_kernel  a GEMM per input-row parity: A = g rows through a
//                       (C, t_out, B) map (no box crosses an utterance; tap
//                       2 reads the box at t' - 1, and TMA zero-fills row -1
//                       and rows past t_out, so the ragged ends need no
//                       code), B = W_p as stored ([tap][in][out], K-major
//                       in the output channel), both K-major. A block does
//                       128 rows t' of parity 0 (taps 0 and 2) and then of
//                       parity 1 (tap 1): every block contracts over 3C (k =
//                       3) or 2C (k = 2), where one GEMM per parity left the
//                       parity-1 blocks half the work. The epilogue, once
//                       per parity, applies gelu'(x^) (exact erf) and the
//                       affine and stores bf16 pairs at rows 2t' + par
//                       (zero from valid to ts). In the first block x^
//                       comes from a tile of x that TMA loads (through the
//                       even/odd views) while the parity's GEMM runs, and
//                       the affine's columns from shared memory, so the
//                       epilogue waits on no global load. da/db are
//                       reduced two 8-column slices at a time: a warp's 16
//                       rows by a reduce-scatter over 8 lanes (7 shuffles
//                       for 8 sums, each lane left with one column's
//                       total), then one fire-and-forget global fp32 add
//                       per lane, so no partial sums sit beside the
//                       accumulators. (Per-slice shuffle trees into
//                       shared-memory float atomics cost 1.05 of L2's
//                       1.9 ms.) That epilogue (an erf and an exp per
//                       element) does not overlap the GEMM within a block,
//                       so the first block's dx runs 64 x 128 tiles with
//                       one consumer warpgroup (wgmma.m64n128k16, 64
//                       accumulators, no setmaxnreg), a 3-stage ring and
//                       two blocks per SM: one block's epilogue runs
//                       under the other's GEMM (L2's dx 1.12 -> 0.97 ms).
//   conv_bwd_dw_kernel  split-K GEMM over the (b, 64-row t step) pieces of
//                       B * t_out rows (no box spans two utterances): A = H
//                       rows 2t + p through the forward's even/odd views (p
//                       = 0 even row t, 1 odd row t, 2 even row t + 1), B =
//                       g rows, both channel-contiguous and read MN-major
//                       (transposed wgmma operands) from 64-wide swizzled
//                       boxes. The splits are sized so the (tap, 128 in x
//                       256 out) tiles fill two waves of one block per SM;
//                       each block adds its fp32 tile into dW through the
//                       ring's shared memory by 8 TMA tensor reductions
//                       (cp.reduce.async.bulk.tensor add) per warpgroup
//                       instead of a scalar atomic per element.
// The fp32 sums (dW over splits, da/db over row tiles) vary in order from
// run to run within fp32 rounding.

#include "common.cuh"
#include "hopper.cuh"

namespace {

// GEMM tiles of the forward and of the backward's dx and dW (TMA + wgmma)
constexpr int kFM = 128;             // rows per block (two warpgroups of 64)
constexpr int kFN = 256;             // columns per block
constexpr int kFK = 64;              // K step: one 128-byte swizzled row of bf16
constexpr int kFStages = 4;
constexpr int kFThreads = 384;       // consumer warpgroups 0, 1; producer warpgroup 2
constexpr uint32_t kFABytes = kFM * kFK * 2;  // 16 KB
constexpr uint32_t kFBBytes = kFN * kFK * 2;  // 32 KB
constexpr uint32_t kBox = 64 * 128;           // one 64 x 64 bf16 (or 64 x 32 fp32) box
constexpr size_t kFSmem = 1024 + (size_t)kFStages * (kFABytes + kFBBytes) + 2 * kFStages * 8;
// the forward GEMM's tile: 128 rows x 128 columns, a fresh sum per K step
constexpr int kGN = 128;
constexpr uint32_t kGBBytes = kGN * kFK * 2;  // 16 KB
constexpr size_t kGSmem = 1024 + (size_t)kFStages * (kFABytes + kGBBytes) + 2 * kFStages * 8;

// ------------------------------------------------------------------ backward

constexpr int kVec = 8;  // bf16 values per 16-byte vector

// g = bf16(gelu'(pre) * dy), elementwise
__global__ void __launch_bounds__(256) conv_bwd_g_kernel(
    const __nv_bfloat16* __restrict__ dy, const __nv_bfloat16* __restrict__ pre,
    __nv_bfloat16* __restrict__ g, size_t n_vec) {
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec;
         i += (size_t)gridDim.x * blockDim.x) {
        const uint4 d4 = reinterpret_cast<const uint4*>(dy)[i];
        const uint4 p4 = reinterpret_cast<const uint4*>(pre)[i];
        uint4 o4;
        const __nv_bfloat16* d = reinterpret_cast<const __nv_bfloat16*>(&d4);
        const __nv_bfloat16* p = reinterpret_cast<const __nv_bfloat16*>(&p4);
        __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&o4);
#pragma unroll
        for (int e = 0; e < kVec; ++e)
            o[e] = usk::f2bf(usk::dgelu_erf(usk::bf2f(p[e])) * usk::bf2f(d[e]));
        reinterpret_cast<uint4*>(g)[i] = o4;
    }
}

// H = bf16(gelu_in?(bf16(x * a + b))) on the valid rows, (B, valid, C): one
// batch row per blockIdx.y; within it x and H are both rows of C, so vector
// i sits at element 8i of either (32-bit index math)
template <bool kAffine, bool kGeluIn>
__global__ void __launch_bounds__(256) conv_h_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ aff_a,
    const float* __restrict__ aff_b, __nv_bfloat16* __restrict__ h, int ts, int valid,
    int C) {
    const int b = blockIdx.y;
    const uint32_t cv = (uint32_t)C / kVec, n = (uint32_t)valid * cv;
    const uint4* xb = reinterpret_cast<const uint4*>(x + (size_t)b * ts * C);
    uint4* hb = reinterpret_cast<uint4*>(h + (size_t)b * valid * C);
    for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
        uint4 v4 = xb[i];
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v4);
        float av[kVec], bv[kVec];
        if (kAffine) {
            const uint32_t c0 = (i % cv) * kVec;
            const float4* pa = reinterpret_cast<const float4*>(aff_a + (size_t)b * C + c0);
            const float4* pb = reinterpret_cast<const float4*>(aff_b + (size_t)b * C + c0);
            const float4 a0 = pa[0], a1 = pa[1], b0 = pb[0], b1 = pb[1];
            av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
            av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
            bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
            bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
        }
#pragma unroll
        for (int q = 0; q < kVec; ++q) {
            float f = usk::bf2f(e[q]);
            // mul then add, each rounded, as the plain version
            if (kAffine) f = usk::round_bf16(__fadd_rn(__fmul_rn(f, av[q]), bv[q]));
            if (kGeluIn) f = usk::gelu_erf(f);
            e[q] = usk::f2bf(f);
        }
        hb[i] = v4;
    }
}

cudaError_t launch_h(const void* x, const void* a, const void* b, void* h, int B, int ts,
                     int valid, int C, bool gelu_in, cudaStream_t stream) {
    const size_t n = (size_t)valid * C / kVec;
    if (n >= (size_t)1 << 31) return cudaErrorInvalidValue;
    const size_t want = (n + 255) / 256, cap = (132 * 16 + B - 1) / B;
    const dim3 grid((unsigned)(want < 1 ? 1 : (want > cap ? cap : want)), B);
    const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
    __nv_bfloat16* hb = (__nv_bfloat16*)h;
    const float *fa = (const float*)a, *fb = (const float*)b;
    if (a != nullptr && gelu_in)
        conv_h_kernel<true, true><<<grid, 256, 0, stream>>>(xb, fa, fb, hb, ts, valid, C);
    else if (a != nullptr)
        conv_h_kernel<true, false><<<grid, 256, 0, stream>>>(xb, fa, fb, hb, ts, valid, C);
    else
        conv_h_kernel<false, true><<<grid, 256, 0, stream>>>(xb, fa, fb, hb, ts, valid, C);
    return cudaGetLastError();
}

// byte offset of fp32 element (r, c) of a 128-byte-swizzled box of 32 per row
__device__ __forceinline__ uint32_t sw128_f32(int r, int c) {
    return (uint32_t)r * 128u + ((((uint32_t)c >> 2) ^ (uint32_t)(r & 7)) << 4) + ((uint32_t)c & 3u) * 4u;
}

struct DxMaps {
    CUtensorMap g;      // g (B, t_out, C): dims {C, t_out, B}, boxes of 64 x 128 rows
    CUtensorMap w;      // W (k, C_in, C_out) as stored: dims {C_out, C_in, k}, boxes of 64 x 256
    CUtensorMap xe, xo; // x's even / odd rows (the first block's epilogue), boxes of 64 x 128
};

// the dx kernel's shape. Without the first block's epilogue arithmetic: the
// forward's (two consumer warpgroups on 128 x 256 tiles, one block per SM).
// With it (gelu'(x^), the affine, the da/db sums): one consumer warpgroup
// on 64 x 128 tiles, two blocks per SM, so one block's epilogue runs while
// the other's GEMM keeps the tensor cores busy. Shared memory: the ring,
// then (first block) the x tile of one parity, the barriers and the
// affine's columns.
template <bool kX>
struct DxCfg {
    static constexpr int kCons = kX ? 1 : 2;  // consumer warpgroups
    static constexpr int kM = 64 * kCons;     // rows t' per block
    static constexpr int kN = kX ? 128 : 256; // input channels per block
    static constexpr int kThreads = 128 * (kCons + 1);
    static constexpr int kMinBlocks = kX ? 2 : 1;
    static constexpr int kStages = kX ? 3 : kFStages;
    static constexpr uint32_t kABytes = kM * 128, kBBytes = kN * 128;
    static constexpr uint32_t kOffB = kStages * kABytes;
    static constexpr uint32_t kOffX = kOffB + kStages * kBBytes;
    static constexpr uint32_t kXBytes = kX ? kM * kN * 2 : 0;
    static constexpr uint32_t kOffBar = kOffX + kXBytes;  // full, empty, x
    static constexpr uint32_t kOffAff = kOffBar + (2 * kStages + 1) * 8 + 8;
    static constexpr size_t kBytes = 1024 + kOffAff + 2 * kN * 4;
};

// dx: per block kM rows t' of both input-row parities (r = 2t' + par) x kN
// input channels; parity 0 contracts over taps 0 (g row t') and 2 (g
// row t' - 1, when k = 3), parity 1 over tap 1 (g row t'), each over the
// output channels, one after the other with one epilogue each. With the
// affine or the input GELU (the first block) the epilogue reads x^'s rows
// from a tile of x that TMA brings in while the parity's GEMM runs.
template <bool kAffine, bool kGeluIn>
__global__ void __launch_bounds__(DxCfg<kAffine || kGeluIn>::kThreads,
                                  DxCfg<kAffine || kGeluIn>::kMinBlocks) conv_bwd_dx_kernel(
    const __grid_constant__ DxMaps maps,
    const float* __restrict__ aff_a, const float* __restrict__ aff_b,  // (B, C) or null
    __nv_bfloat16* __restrict__ dx,        // (B, ts, C)
    float* __restrict__ da, float* __restrict__ db,  // (B, C) zeroed, or null
    int ts, int valid, int C, int k) {
    constexpr bool kX = kAffine || kGeluIn;
    using L = DxCfg<kX>;
    constexpr int kS = L::kStages, kCons = L::kCons, kM = L::kM, kN = L::kN;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    unsigned char* sA = smem;              // [stage][kM rows][128 B]
    unsigned char* sB = smem + L::kOffB;   // [stage][kN rows][128 B]
    unsigned char* sX = smem + L::kOffX;   // [kN / 64 channel boxes][kM rows][128 B]
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kOffBar);
    uint64_t* empty = full + kS;
    uint64_t* x_bar = empty + kS;
    float* aff = reinterpret_cast<float*>(smem + L::kOffAff);  // [2][kN]: a, b columns

    const int n0 = blockIdx.x * kN, m0 = blockIdx.y * kM, b = blockIdx.z;
    const int steps = C / kFK;                   // per tap
    const int nk0 = (k == 3 ? 2 : 1) * steps;    // parity 0
    const int nk = nk0 + steps;                  // and parity 1
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    // the x tile of parity par (its rows 2t' + par), issued by one consumer thread
    auto issue_x = [&](int par) {
        usk::mbar_expect_tx(x_bar, L::kXBytes);
        for (int i = 0; i < kN / 64; ++i)
            usk::tma_load_3d(sX + i * kM * 128, par ? &maps.xo : &maps.xe, x_bar, n0 + 64 * i,
                             m0, b);
    };
    if (threadIdx.x == 0) {
        for (int s = 0; s < kS; ++s) {
            usk::mbar_init(&full[s], 1);
            usk::mbar_init(&empty[s], kCons);  // one arrival per consumer warpgroup
        }
        usk::mbar_init(x_bar, 1);
        usk::fence_barrier_init();
    }
    if (kAffine && threadIdx.x < kN) {
        const int n = n0 + threadIdx.x;
        aff[threadIdx.x] = n < C ? aff_a[(size_t)b * C + n] : 0.f;
        aff[kN + threadIdx.x] = n < C ? aff_b[(size_t)b * C + n] : 0.f;
    }
    __syncthreads();

    if (wg == kCons) {  // producer
        if (kCons == 2) usk::reg_dealloc<40>();
        if (tid == 0) {
            for (int ks = 0; ks < nk; ++ks) {
                const int s = ks % kS;
                usk::mbar_wait(&empty[s], ((ks / kS) & 1) ^ 1);
                usk::mbar_expect_tx(&full[s], L::kABytes + L::kBBytes);
                const int p = ks < nk0 ? (ks < steps ? 0 : 2) : 1;
                const int c0 = (ks % steps) * kFK;
                // tap 2 reads g row t' - 1: the box at m0 - 1 (row -1 loads as zeros)
                usk::tma_load_3d(sA + s * L::kABytes, &maps.g, &full[s], c0, m0 - (p >> 1), b);
                usk::tma_load_3d(sB + s * L::kBBytes, &maps.w, &full[s], c0, n0, p);
            }
        }
        return;
    }
    if (kCons == 2) usk::reg_alloc<232>();
    if (kX && threadIdx.x == 0) issue_x(0);
    const int warp = tid / 32, lane = tid % 32;
    const int gq = lane >> 2, c2 = (lane & 3) * 2;
    float acc[kN / 2];
#pragma unroll 1
    for (int par = 0; par < 2; ++par) {
        const int lo = par ? nk0 : 0, hi = par ? nk : nk0;
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
        for (int ks = lo; ks < hi; ++ks) {
            const int s = ks % kS;
            usk::mbar_wait(&full[s], (ks / kS) & 1);
            const unsigned char* a = sA + s * L::kABytes + wg * 64 * 128;
            const unsigned char* bt = sB + s * L::kBBytes;
            usk::fence_regs(acc);
            usk::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kFK / 16; ++kk) {
                const uint64_t da_ = usk::desc_sw128(a + kk * 32, 16, 1024);
                const uint64_t db_ = usk::desc_sw128(bt + kk * 32, 16, 1024);
                if constexpr (kN == 256) usk::wgmma_m64n256k16_ss<0, 0>(acc, da_, db_);
                else usk::wgmma_m64n128k16_ss<0, 0>(acc, da_, db_);
            }
            usk::wgmma_commit();
            usk::wgmma_wait<1>();  // the previous step's products are done
            usk::fence_regs(acc);
            if (ks > lo && tid == 0) usk::mbar_arrive(&empty[(ks - 1) % kS]);
        }
        usk::wgmma_wait<0>();
        usk::fence_regs(acc);
        if (tid == 0) usk::mbar_arrive(&empty[(hi - 1) % kS]);
        if (kX) usk::mbar_wait(x_bar, par);

        // epilogue: input rows r = 2t' + par of this warp's rows t' (g, g + 8);
        // gelu'(x^) and the affine, bf16 pairs; rows in [valid, ts) zero
        int row[2];
        bool in_ts[2], in_valid[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            row[e] = 2 * (m0 + wg * 64 + warp * 16 + gq + 8 * e) + par;
            in_ts[e] = row[e] < ts;
            in_valid[e] = row[e] < valid;
        }
#pragma unroll
        for (int jp = 0; jp < kN / 16; ++jp) {
            if (n0 + jp * 16 >= C) break;  // uniform over the block: C % 128 == 0
            // v * x and v of this lane's rows, per (slice jj, column q):
            // sums[jj * 4 + q] (da), sums[jj * 4 + 2 + q] (db)
            float sums[8];
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
                const int j = 2 * jp + jj;
                const int n = n0 + j * 8 + c2;
                float sa[2] = {0.f, 0.f}, sb[2] = {0.f, 0.f};
                float2 av = make_float2(1.f, 1.f), bv = make_float2(0.f, 0.f);
                if (kAffine) {
                    av = *reinterpret_cast<const float2*>(aff + j * 8 + c2);
                    bv = *reinterpret_cast<const float2*>(aff + kN + j * 8 + c2);
                }
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    if (!in_ts[e]) continue;
                    const size_t off = ((size_t)b * ts + row[e]) * C + n;
                    float v[2] = {0.f, 0.f};
                    if (in_valid[e]) {
                        v[0] = acc[4 * j + 2 * e];
                        v[1] = acc[4 * j + 2 * e + 1];
                        if (kX) {
                            const int rl = wg * 64 + warp * 16 + gq + 8 * e;
                            const float2 xf = __bfloat1622float2(
                                *reinterpret_cast<const __nv_bfloat162*>(
                                    sX + (j >> 3) * kM * 128 + usk::sw128_offset(rl, (j & 7) * 8 + c2)));
                            const float xr[2] = {xf.x, xf.y};
                            const float ar[2] = {av.x, av.y}, br[2] = {bv.x, bv.y};
#pragma unroll
                            for (int q = 0; q < 2; ++q) {
                                float xh = xr[q];
                                if (kAffine) xh = usk::round_bf16(__fadd_rn(__fmul_rn(xh, ar[q]), br[q]));
                                if (kGeluIn) v[q] = v[q] * usk::dgelu_erf(xh);
                                if (kAffine) {
                                    sa[q] += v[q] * xr[q];
                                    sb[q] += v[q];
                                    v[q] = v[q] * ar[q];
                                }
                            }
                        }
                    }
                    *reinterpret_cast<__nv_bfloat162*>(dx + off) = __floats2bfloat162_rn(v[0], v[1]);
                }
                sums[jj * 4] = sa[0];
                sums[jj * 4 + 1] = sa[1];
                sums[jj * 4 + 2] = sb[0];
                sums[jj * 4 + 3] = sb[1];
            }
            if (kAffine) {
                // sums over the warp's 16 rows (the 8 lanes of one c2): a
                // reduce-scatter in 7 shuffles leaves lane gq with the total
                // of sums[gq]; one fire-and-forget global add per lane
                float s4[4], s2[2];
                const bool hi2 = gq & 4, hi1 = gq & 2, hi0 = gq & 1;
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float send = hi2 ? sums[i] : sums[i + 4];
                    s4[i] = (hi2 ? sums[i + 4] : sums[i]) + __shfl_xor_sync(0xffffffffu, send, 16);
                }
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const float send = hi1 ? s4[i] : s4[i + 2];
                    s2[i] = (hi1 ? s4[i + 2] : s4[i]) + __shfl_xor_sync(0xffffffffu, send, 8);
                }
                const float send = hi0 ? s2[0] : s2[1];
                const float total = (hi0 ? s2[1] : s2[0]) + __shfl_xor_sync(0xffffffffu, send, 4);
                // sums index gq = jj * 4 + (db ? 2 : 0) + q
                const int col = n0 + (2 * jp + (gq >> 2)) * 8 + c2 + (gq & 1);
                atomicAdd(((gq & 2) ? db : da) + (size_t)b * C + col, total);
            }
        }
        if (kX && par == 0) {  // both warpgroups are done with x's even rows
            usk::named_bar_sync(1, kCons * 128);
            if (threadIdx.x == 0) issue_x(1);
        }
    }
}

struct DwMaps {
    CUtensorMap even;  // H rows 2r   of (B, th, C): dims {C, ceil(th/2), B}, boxes of 64 x 64
    CUtensorMap odd;   // H rows 2r+1:                 dims {C, floor(th/2), B}
    CUtensorMap g;     // g (B, t_out, C): dims {C, t_out, B}, boxes of 64 x 64
    CUtensorMap dw;    // fp32 dW (k, C_in, C_out): dims {C_out, C_in, k}, boxes of 32 x 64
};

// dW_p[in, out] = sum over rows (b, t) of H[b, 2t + p, in] * g[b, t, out]:
// per block one (tap, 128 in x 256 out) tile and one range of the B *
// ceil(t_out / 64) 64-row K steps (each inside one utterance), both
// operands MN-major; the block's fp32 tile is added into dW by TMA tensor
// reductions of 32 x 64 boxes
__global__ void __launch_bounds__(kFThreads, 1) conv_bwd_dw_kernel(
    const __grid_constant__ DwMaps maps, int C, int k, int nkb, int total_steps,
    int steps_per_split) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    unsigned char* sA = smem;                        // [stage][2 boxes: 64 rows x 64 in]
    unsigned char* sB = smem + kFStages * kFABytes;  // [stage][4 boxes: 64 rows x 64 out]
    uint64_t* full = reinterpret_cast<uint64_t*>(sB + kFStages * kFBBytes);
    uint64_t* empty = full + kFStages;

    const int n0 = blockIdx.x * kFN, m0 = blockIdx.y * kFM;
    const int p = blockIdx.z % k, split = blockIdx.z / k;
    const int s_lo = split * steps_per_split;
    const int s_hi = min(s_lo + steps_per_split, total_steps);
    const int nk = s_hi - s_lo;
    const int nbox = min(kFN / 64, (C - n0) / 64);  // g boxes inside C
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    if (threadIdx.x == 0) {
        for (int s = 0; s < kFStages; ++s) {
            usk::mbar_init(&full[s], 1);
            usk::mbar_init(&empty[s], 2);
        }
        usk::fence_barrier_init();
    }
    __syncthreads();

    if (wg == 2) {  // producer
        usk::reg_dealloc<40>();
        if (tid == 0) {
            // H row 2t + p: even row t (p = 0), odd row t (p = 1), even row t + 1 (p = 2)
            const CUtensorMap* hmap = p == 1 ? &maps.odd : &maps.even;
            for (int ks = 0; ks < nk; ++ks) {
                const int s = ks % kFStages;
                usk::mbar_wait(&empty[s], ((ks / kFStages) & 1) ^ 1);
                usk::mbar_expect_tx(&full[s], kFABytes + nbox * kBox);
                const int step = s_lo + ks, bq = step / nkb, t0 = (step % nkb) * 64;
                unsigned char* a = sA + s * kFABytes;
                usk::tma_load_3d(a, hmap, &full[s], m0, t0 + (p >> 1), bq);
                usk::tma_load_3d(a + kBox, hmap, &full[s], m0 + 64, t0 + (p >> 1), bq);
                for (int bx = 0; bx < nbox; ++bx)
                    usk::tma_load_3d(sB + s * kFBBytes + bx * kBox, &maps.g, &full[s],
                                     n0 + 64 * bx, t0, bq);
            }
        }
        return;
    }
    usk::reg_alloc<232>();
    float acc[kFN / 2];
#pragma unroll
    for (int i = 0; i < kFN / 2; ++i) acc[i] = 0.f;
    for (int ks = 0; ks < nk; ++ks) {
        const int s = ks % kFStages;
        usk::mbar_wait(&full[s], (ks / kFStages) & 1);
        const unsigned char* a = sA + s * kFABytes + wg * kBox;
        const unsigned char* bt = sB + s * kFBBytes;
        usk::fence_regs(acc);
        usk::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 64 / 16; ++kk)
            usk::wgmma_m64n256k16_ss<1, 1>(acc, usk::desc_sw128(a + kk * 2048, kBox, 1024),
                                           usk::desc_sw128(bt + kk * 2048, kBox, 1024));
        usk::wgmma_commit();
        usk::wgmma_wait<1>();
        usk::fence_regs(acc);
        if (ks > 0 && tid == 0) usk::mbar_arrive(&empty[(ks - 1) % kFStages]);
    }
    usk::wgmma_wait<0>();
    usk::fence_regs(acc);

    // the ring is free once both warpgroups' products are done: stage this
    // warpgroup's 64 x 256 fp32 tile there as eight swizzled 32-wide boxes
    usk::named_bar_sync(1, 2 * 128);
    unsigned char* stg = smem + wg * 8 * kBox;
    const int warp = tid / 32, lane = tid % 32;
    const int gq = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        const int r = warp * 16 + gq + 8 * e;
#pragma unroll
        for (int j = 0; j < kFN / 8; ++j)
            *reinterpret_cast<float2*>(stg + (j >> 2) * kBox + sw128_f32(r, (j & 3) * 8 + c2)) =
                make_float2(acc[4 * j + 2 * e], acc[4 * j + 2 * e + 1]);
    }
    usk::fence_proxy_async();
    usk::named_bar_sync(2 + wg, 128);
    if (tid == 0) {
        for (int bx = 0; bx < 8 && n0 + 32 * bx < C; ++bx)
            usk::tma_reduce_add_3d(&maps.dw, stg + bx * kBox, n0 + 32 * bx, m0 + 64 * wg, p);
        usk::bulk_commit();
        usk::bulk_wait();
    }
}

int grid_for(size_t n_vec) {
    const size_t blocks = (n_vec + 255) / 256;
    return (int)(blocks < 132 * 16 ? blocks : 132 * 16);
}

// the even/odd row views of src (B, rows, C) (row stride 2C) with boxes of
// 64 channels x box_rows rows
bool parity_maps(CUtensorMap* even, CUtensorMap* odd, const void* src, int B, int rows, int C,
                 uint32_t box_rows) {
    const uint64_t strides[2] = {(uint64_t)2 * C * 2, (uint64_t)rows * C * 2};
    const uint64_t even_dims[3] = {(uint64_t)C, (uint64_t)(rows + 1) / 2, (uint64_t)B};
    const uint64_t odd_dims[3] = {(uint64_t)C, (uint64_t)rows / 2, (uint64_t)B};
    const uint32_t box[3] = {kFK, box_rows, 1};
    const __nv_bfloat16* x = (const __nv_bfloat16*)src;
    return usk::make_tensor_map(even, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, x, even_dims, strides,
                                box, CU_TENSOR_MAP_SWIZZLE_128B) &&
           usk::make_tensor_map(odd, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, x + C, odd_dims,
                                strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// g (B, t_out, C) with boxes of 64 channels x box_rows rows
bool g_map(CUtensorMap* m, const void* g, int B, int t_out, int C, uint32_t box_rows) {
    const uint64_t dims[3] = {(uint64_t)C, (uint64_t)t_out, (uint64_t)B};
    const uint64_t strides[2] = {(uint64_t)C * 2, (uint64_t)t_out * C * 2};
    const uint32_t box[3] = {kFK, box_rows, 1};
    return usk::make_tensor_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, g, dims, strides, box,
                                CU_TENSOR_MAP_SWIZZLE_128B);
}

// which of the two GEMMs a backward call launches (the g and H passes always
// run); a call with one of them times that kernel alone
constexpr int kBwdDx = 1, kBwdDw = 2;

template <bool kAffine, bool kGeluIn>
cudaError_t launch_bwd(const void* x, const void* w, const void* a, const void* bb,
                       const void* gsrc, void* h_buf, void* dx, void* dw, void* da, void* db,
                       int B, int ts, int valid, int t_out, int C, int k, int parts,
                       cudaStream_t stream) {
    const void* hsrc = x;
    int th = ts;
    if (kAffine || kGeluIn) {
        const cudaError_t err = launch_h(x, a, bb, h_buf, B, ts, valid, C, kGeluIn, stream);
        if (err != cudaSuccess) return err;
        hsrc = h_buf;
        th = valid;
    }
    using L = DxCfg<kAffine || kGeluIn>;
    DxMaps dxm;
    const uint64_t w_dims[3] = {(uint64_t)C, (uint64_t)C, (uint64_t)k};
    const uint64_t w_strides[2] = {(uint64_t)C * 2, (uint64_t)C * C * 2};
    const uint32_t w_box[3] = {kFK, L::kN, 1};
    if (!g_map(&dxm.g, gsrc, B, t_out, C, L::kM) ||
        !usk::make_tensor_map(&dxm.w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, w, w_dims, w_strides,
                              w_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !parity_maps(&dxm.xe, &dxm.xo, x, B, ts, C, L::kM))
        return cudaErrorInvalidValue;
    DwMaps dwm;
    const uint64_t dw_strides[2] = {(uint64_t)C * 4, (uint64_t)C * C * 4};
    const uint32_t dw_box[3] = {32, 64, 1};
    if (!parity_maps(&dwm.even, &dwm.odd, hsrc, B, th, C, 64) ||
        !g_map(&dwm.g, gsrc, B, t_out, C, 64) ||
        !usk::make_tensor_map(&dwm.dw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, dw, w_dims, dw_strides,
                              dw_box, CU_TENSOR_MAP_SWIZZLE_128B))
        return cudaErrorInvalidValue;

    auto dx_kernel = conv_bwd_dx_kernel<kAffine, kGeluIn>;
    cudaError_t err = cudaFuncSetAttribute(dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)L::kBytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(conv_bwd_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kFSmem);
    if (err != cudaSuccess) return err;
    // both parities of kM rows t' per block: ceil(ts / 2) rows cover every input row
    const dim3 gdx((C + L::kN - 1) / L::kN, ((ts + 1) / 2 + L::kM - 1) / L::kM, B);
    if (parts & kBwdDx) {
        dx_kernel<<<gdx, L::kThreads, L::kBytes, stream>>>(
            dxm, (const float*)a, (const float*)bb, (__nv_bfloat16*)dx,
            (float*)da, (float*)db, ts, valid, C, k);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }
    // split the B * ceil(t_out / 64) K steps so the tiles fill two waves of
    // one block per SM
    const int nkb = (t_out + 63) / 64, total_steps = B * nkb;
    const int tiles = k * (C / kFM) * ((C + kFN - 1) / kFN);
    int splits = 2 * 132 / tiles;
    const int max_splits = (total_steps + 3) / 4;  // at least ~4 steps each
    splits = splits < 1 ? 1 : (splits > max_splits ? max_splits : splits);
    const int per_split = (total_steps + splits - 1) / splits;
    splits = (total_steps + per_split - 1) / per_split;
    const dim3 gdw((C + kFN - 1) / kFN, C / kFM, k * splits);
    if (parts & kBwdDw)
        conv_bwd_dw_kernel<<<gdw, kFThreads, kFSmem, stream>>>(dwm, C, k, nkb, total_steps,
                                                               per_split);
    return cudaGetLastError();
}

// ------------------------------------------------------------------ forward

struct ConvMaps {
    CUtensorMap even;  // input rows 2r   of (B, ts, C): dims {C, ceil(ts/2), B}
    CUtensorMap odd;   // input rows 2r+1:                dims {C, floor(ts/2), B}
    CUtensorMap w;     // weight (C_out, k * C_in):       dims {k * C, C_out}
};

template <bool kGeluOut>
__global__ void __launch_bounds__(kFThreads, 1) conv_gemm_kernel(
    const __grid_constant__ ConvMaps maps, __nv_bfloat16* __restrict__ y,
    __nv_bfloat16* __restrict__ pre, int t_out, int C, int k) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    unsigned char* sA = smem;                             // [stage][128 rows][128 B]
    unsigned char* sB = smem + kFStages * kFABytes;       // [stage][128 rows][128 B]
    uint64_t* full = reinterpret_cast<uint64_t*>(sB + kFStages * kGBBytes);
    uint64_t* empty = full + kFStages;

    const int n0 = blockIdx.x * kGN, m0 = blockIdx.y * kFM, b = blockIdx.z;
    const int nk = k * C / kFK;
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    if (threadIdx.x == 0) {
        for (int s = 0; s < kFStages; ++s) {
            usk::mbar_init(&full[s], 1);
            usk::mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
        }
        usk::fence_barrier_init();
    }
    __syncthreads();

    if (wg == 2) {  // producer
        usk::reg_dealloc<40>();
        if (tid == 0) {
            for (int ks = 0; ks < nk; ++ks) {
                const int s = ks % kFStages;
                usk::mbar_wait(&empty[s], ((ks / kFStages) & 1) ^ 1);
                usk::mbar_expect_tx(&full[s], kFABytes + kGBBytes);
                const int kk = ks * kFK, tap = kk / C, c0 = kk % C;
                // tap 0: even row t, tap 1: odd row t, tap 2: even row t + 1
                usk::tma_load_3d(sA + s * kFABytes, tap == 1 ? &maps.odd : &maps.even, &full[s],
                                 c0, m0 + (tap >> 1), b);
                usk::tma_load_2d(sB + s * kGBBytes, &maps.w, &full[s], kk, n0);
            }
        }
    } else {  // consumers: rows m0 + 64 * wg ...
        usk::reg_alloc<232>();
        // each K step's 64-deep products go into a fresh sum that one fp32
        // add puts into the running sum (see the header)
        float acc[kGN / 2], fresh[kGN / 2];
#pragma unroll
        for (int i = 0; i < kGN / 2; ++i) acc[i] = fresh[i] = 0.f;
        for (int ks = 0; ks < nk; ++ks) {
            const int s = ks % kFStages;
            usk::mbar_wait(&full[s], (ks / kFStages) & 1);
            const unsigned char* a = sA + s * kFABytes + wg * 64 * 128;
            const unsigned char* bt = sB + s * kGBBytes;
            usk::fence_regs(fresh);
            usk::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kFK / 16; ++kk)
                usk::wgmma_m64n128k16_ss<0, 0>(fresh, usk::desc_sw128(a + kk * 32, 16, 1024),
                                               usk::desc_sw128(bt + kk * 32, 16, 1024),
                                               kk > 0 ? 1 : 0);
            usk::wgmma_commit();
            usk::wgmma_wait<0>();
            usk::fence_regs(fresh);
            if (tid == 0) usk::mbar_arrive(&empty[s]);
#pragma unroll
            for (int i = 0; i < kGN / 2; ++i) acc[i] = __fadd_rn(acc[i], fresh[i]);
        }

        // epilogue: rows r / r + 8 of this warp's 16, column pairs of each
        // 8-wide slice j
        const int warp = tid / 32, lane = tid % 32;
        const int c2 = (lane & 3) * 2;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int t = m0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * e;
            if (t >= t_out) continue;
            const size_t row = ((size_t)b * t_out + t) * C;
#pragma unroll
            for (int j = 0; j < kGN / 8; ++j) {
                const int n = n0 + j * 8 + c2;
                if (n >= C) continue;
                float v0 = acc[4 * j + 2 * e], v1 = acc[4 * j + 2 * e + 1];
                if (pre != nullptr)
                    *reinterpret_cast<__nv_bfloat162*>(pre + row + n) = __floats2bfloat162_rn(v0, v1);
                if (kGeluOut) {
                    v0 = usk::gelu_erf(v0);
                    v1 = usk::gelu_erf(v1);
                }
                *reinterpret_cast<__nv_bfloat162*>(y + row + n) = __floats2bfloat162_rn(v0, v1);
            }
        }
    }
}

// the GEMM of one block on its source rows src (B, ts, C) (the input, or H)
cudaError_t launch_conv_gemm(const void* src, const void* w_t, void* y, void* pre, int B, int ts,
                             int t_out, int C, int k, bool gelu_out, cudaStream_t stream) {
    ConvMaps maps;
    const uint64_t w_dims[2] = {(uint64_t)k * C, (uint64_t)C};
    const uint64_t w_strides[1] = {(uint64_t)k * C * 2};
    const uint32_t w_box[2] = {kFK, kGN};
    if (!parity_maps(&maps.even, &maps.odd, src, B, ts, C, kFM) ||
        !usk::make_tensor_map(&maps.w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w_t, w_dims,
                              w_strides, w_box, CU_TENSOR_MAP_SWIZZLE_128B))
        return cudaErrorInvalidValue;
    auto kernel = gelu_out ? conv_gemm_kernel<true> : conv_gemm_kernel<false>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kGSmem);
    if (err != cudaSuccess) return err;
    // channel tiles fastest: the tiles sharing an A row block run together
    const dim3 grid((C + kGN - 1) / kGN, (t_out + kFM - 1) / kFM, B);
    kernel<<<grid, kFThreads, kGSmem, stream>>>(maps, (__nv_bfloat16*)y, (__nv_bfloat16*)pre,
                                                t_out, C, k);
    return cudaGetLastError();
}

}  // namespace

// x (B, ts, C) with valid rows [0, valid); w_t the weight as (C_out, k * C_in);
// h_buf (B, valid, C) scratch for H, used with the affine or the input GELU
extern "C" int usk_conv_gelu_block(const void* x, const void* w_t, const void* a,
                                   const void* b, void* h_buf, void* y, void* pre, int B,
                                   int ts, int valid, int t_out, int C, int k, int gelu_in,
                                   int gelu_out, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    const void* src = x;
    int rows = ts;
    if (a != nullptr || gelu_in) {
        const cudaError_t err = launch_h(x, a, b, h_buf, B, ts, valid, C, gelu_in != 0, s);
        if (err != cudaSuccess) return (int)err;
        src = h_buf;
        rows = valid;
    }
    return (int)launch_conv_gemm(src, w_t, y, pre, B, rows, t_out, C, k, gelu_out != 0, s);
}

extern "C" int usk_conv_gelu_block_bwd(const void* x, const void* w, const void* a,
                                       const void* b, const void* dy, const void* pre,
                                       void* g_buf, void* h_buf, void* dx, void* dw, void* da,
                                       void* db, int B, int ts, int valid, int t_out, int C,
                                       int k, int gelu_in, int parts, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    const void* gsrc = dy;
    if (pre != nullptr) {
        const size_t n_vec = (size_t)B * t_out * C / kVec;
        conv_bwd_g_kernel<<<grid_for(n_vec), 256, 0, s>>>(
            (const __nv_bfloat16*)dy, (const __nv_bfloat16*)pre, (__nv_bfloat16*)g_buf, n_vec);
        gsrc = g_buf;
    }
    const int sel = (a != nullptr ? 2 : 0) | (gelu_in ? 1 : 0);
    switch (sel) {
        case 0: return (int)launch_bwd<false, false>(x, w, a, b, gsrc, h_buf, dx, dw, da, db, B, ts, valid, t_out, C, k, parts, s);
        case 1: return (int)launch_bwd<false, true>(x, w, a, b, gsrc, h_buf, dx, dw, da, db, B, ts, valid, t_out, C, k, parts, s);
        case 2: return (int)launch_bwd<true, false>(x, w, a, b, gsrc, h_buf, dx, dw, da, db, B, ts, valid, t_out, C, k, parts, s);
        default: return (int)launch_bwd<true, true>(x, w, a, b, gsrc, h_buf, dx, dw, da, db, B, ts, valid, t_out, C, k, parts, s);
    }
}
