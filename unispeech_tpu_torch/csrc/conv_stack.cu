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
//  - one block per 128 x 256 output tile: a producer warp keeps TMA loads
//    of 64-deep K steps (A 128 x 64 of the input, B 256 x 64 of the weight
//    transposed to (C_out, k * C_in), both 128-byte swizzled) in a 4-stage
//    ring on mbarriers; two consumer warpgroups (setmaxnreg 232) each run
//    wgmma.m64n256k16 on 64 of the rows with fp32 accumulators in
//    registers, one wgmma group in flight while the previous stage is
//    released to the producer;
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
// 0.91 ms at the bf16 tensor-core peak. Design, in four launches:
//   conv_bwd_g_kernel   g (elementwise, 16-byte vectors; skipped without
//                       the output GELU, where g is dy itself)
//   conv_h_kernel       H (elementwise; only with affine or gelu_in, i.e.
//                       the first block of the chain; shared with the forward)
//   conv_bwd_dx_kernel  one GEMM per input-row parity: 128 input rows of one
//                       parity x 128 input channels per block, contraction
//                       over (tap, output channel), A rows gathered from g
//                       (zero-filled outside [0, t_out)), B = W_p read as
//                       [in][out] rows; mma.sync and ldmatrix on a
//                       3-stage cp.async ring. No overlap-add
//                       and no atomics for dx; the epilogue applies gelu'
//                       and the affine and reduces da/db per block (warp
//                       shuffles, shared-memory atomics) into fp32 atomics.
//   conv_bwd_dw_kernel  split-K GEMM over the B * t_out rows: a block owns
//                       a (tap, 128 in x 128 out) tile and one row range,
//                       A = H rows 2t + p read transposed by ldmatrix.trans,
//                       B = g rows; fp32 atomics add the splits into dW.
// The atomic sums (dW over row splits, da/db over row tiles) vary in order
// from run to run within fp32 rounding.

#include "common.cuh"
#include "hopper.cuh"

namespace {

// backward tiles (mma.sync)
constexpr int kBM = 128;  // rows per block
constexpr int kBN = 128;  // channels per block
constexpr int kBK = 32;   // contraction step
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kALd = kBK + 8;  // padded rows (bf16): ldmatrix reads conflict-free

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src));
}
// zero-fills the 16 bytes when !valid (the source address must still be mapped)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N)); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
// D = A.B + D, A 16x16 row-major bf16, B 16x8 col-major bf16, D fp32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// dx: 128 input rows of one parity (r = 2t' + par) x 128 input channels per
// block; contraction over (tap p = par, par + 2 < k) x output channels
template <bool kAffine, bool kGeluIn>
__global__ void __launch_bounds__(kThreads) conv_bwd_dx_kernel(
    const __nv_bfloat16* __restrict__ g,   // (B, t_out, C)
    const __nv_bfloat16* __restrict__ w,   // (k, C, C) [tap][in][out]
    const __nv_bfloat16* __restrict__ x,   // (B, ts, C)
    const float* __restrict__ aff_a, const float* __restrict__ aff_b,  // (B, C) or null
    __nv_bfloat16* __restrict__ dx,        // (B, ts, C)
    float* __restrict__ da, float* __restrict__ db,  // (B, C) zeroed, or null
    int ts, int valid, int t_out, int C, int k) {
    extern __shared__ __align__(128) unsigned char smem[];
    auto* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [kStages][kBM][kALd]: g rows
    auto* Bs = As + kStages * kBM * kALd;              // [kStages][kBN][kALd]: W_p rows
    auto* red = reinterpret_cast<float*>(Bs + kStages * kBN * kALd);  // [2][kBN]

    const int par = blockIdx.z & 1, b = blockIdx.z >> 1;
    const int m0 = blockIdx.x * kBM;  // first parity row t'
    const int n0 = blockIdx.y * kBN;  // first input channel
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int wm = warp / 2, wn = warp % 2, mat = lane >> 3;
    const int steps = C / kBK;  // per tap
    const int ntaps = (par == 0 && k == 3) ? 2 : 1;
    const int nk = ntaps * steps;
    if (kAffine)
        for (int i = tid; i < 2 * kBN; i += kThreads) red[i] = 0.f;

    float acc[2][8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

    auto copy = [&](int ks) {
        const int slot = ks % kStages;
        const int p = par + 2 * (ks / steps), k0 = (ks % steps) * kBK;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int ch = tid + i * kThreads;
            const int r = ch >> 2, cc = (ch & 3) * 8;
            const int t = m0 + r - (p >> 1);  // g row feeding input row 2(m0 + r) + par
            const bool ok = t >= 0 && t < t_out;
            cp_async16_zfill(As + (slot * kBM + r) * kALd + cc,
                             g + ((size_t)b * t_out + (ok ? t : 0)) * C + k0 + cc, ok);
            cp_async16(Bs + (slot * kBN + r) * kALd + cc,
                       w + ((size_t)p * C + n0 + r) * C + k0 + cc);
        }
    };

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < nk) copy(s);
        cp_async_commit();
    }
    for (int ks = 0; ks < nk; ++ks) {
        cp_async_wait<kStages - 2>();
        __syncthreads();
        if (ks + kStages - 1 < nk) copy(ks + kStages - 1);
        cp_async_commit();
        const __nv_bfloat16* At = As + (ks % kStages) * kBM * kALd;
        const __nv_bfloat16* Bt = Bs + (ks % kStages) * kBN * kALd;
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16) {
            uint32_t af[2][4];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                ldmatrix_x4(af[i], At + (wm * 32 + i * 16 + (lane & 15)) * kALd + kk + (lane >> 4) * 8);
#pragma unroll
            for (int jp = 0; jp < 4; ++jp) {
                uint32_t bf[4];  // B[k = out][n = in] from rows n of W_p: not transposed
                ldmatrix_x4(bf, Bt + (wn * 64 + jp * 16 + (mat >> 1) * 8 + (lane & 7)) * kALd +
                                    kk + (mat & 1) * 8);
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    mma_bf16(acc[i][2 * jp], af[i], bf[0], bf[1]);
                    mma_bf16(acc[i][2 * jp + 1], af[i], bf[2], bf[3]);
                }
            }
        }
    }

    const int gq = lane >> 2, c2 = (lane & 3) * 2;
    float pa[8][2], pb[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) pa[j][0] = pa[j][1] = pb[j][0] = pb[j][1] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int r = 2 * (m0 + wm * 32 + i * 16 + gq + 8 * e) + par;
            if (r >= ts) continue;
            const size_t off = ((size_t)b * ts + r) * C + n0 + wn * 64 + c2;
            if (r >= valid) {
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    *reinterpret_cast<__nv_bfloat162*>(dx + off + j * 8) = __floats2bfloat162_rn(0.f, 0.f);
                continue;
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                float v[2] = {acc[i][j][2 * e], acc[i][j][2 * e + 1]};
                if (kAffine || kGeluIn) {
                    const float2 xf = __bfloat1622float2(
                        *reinterpret_cast<const __nv_bfloat162*>(x + off + j * 8));
                    const float xr[2] = {xf.x, xf.y};
#pragma unroll
                    for (int q = 0; q < 2; ++q) {
                        const int ci = b * C + n0 + wn * 64 + j * 8 + c2 + q;
                        float xh = xr[q];
                        if (kAffine) xh = usk::round_bf16(__fadd_rn(__fmul_rn(xh, aff_a[ci]), aff_b[ci]));
                        if (kGeluIn) v[q] = v[q] * usk::dgelu_erf(xh);
                        if (kAffine) {
                            pa[j][q] += v[q] * xr[q];
                            pb[j][q] += v[q];
                            v[q] = v[q] * aff_a[ci];
                        }
                    }
                }
                *reinterpret_cast<__nv_bfloat162*>(dx + off + j * 8) = __floats2bfloat162_rn(v[0], v[1]);
            }
        }
    }
    if (kAffine) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                float sa = pa[j][q], sb = pb[j][q];
#pragma unroll
                for (int sh = 4; sh < 32; sh <<= 1) {
                    sa += __shfl_xor_sync(0xffffffffu, sa, sh);
                    sb += __shfl_xor_sync(0xffffffffu, sb, sh);
                }
                if (gq == 0) {
                    atomicAdd(&red[wn * 64 + j * 8 + c2 + q], sa);
                    atomicAdd(&red[kBN + wn * 64 + j * 8 + c2 + q], sb);
                }
            }
        }
        __syncthreads();
        if (tid < kBN) {
            atomicAdd(da + (size_t)b * C + n0 + tid, red[tid]);
            atomicAdd(db + (size_t)b * C + n0 + tid, red[kBN + tid]);
        }
    }
}

// dW_p[in, out] = sum over rows (b, t) of H[b, 2t + p, in] * g[b, t, out]:
// a (tap, 128 in x 128 out) tile and one range of B * t_out rows per block
constexpr int kWLd = kBN + 8;  // [row][channel] tiles, 128 channels + pad
__global__ void __launch_bounds__(kThreads) conv_bwd_dw_kernel(
    const __nv_bfloat16* __restrict__ hsrc,  // (B, th, C): rows 2t + p
    const __nv_bfloat16* __restrict__ g,     // (B, t_out, C)
    float* __restrict__ dw,                  // (k, C, C) zeroed
    int th, int t_out, int C, int k, int rows_per_split, int total_rows) {
    extern __shared__ __align__(128) unsigned char smem[];
    auto* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [kStages][kBK][kWLd]: H rows
    auto* Bs = As + kStages * kBK * kWLd;              // [kStages][kBK][kWLd]: g rows

    const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
    const int p = blockIdx.z % k, split = blockIdx.z / k;
    const int R0 = split * rows_per_split;
    const int R1 = min(R0 + rows_per_split, total_rows);
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int wm = warp / 2, wn = warp % 2, mat = lane >> 3;
    const int nk = R1 > R0 ? (R1 - R0 + kBK - 1) / kBK : 0;

    float acc[2][8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

    auto copy = [&](int ks) {
        const int slot = ks % kStages;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int ch = tid + i * kThreads;
            const int rr = ch >> 4, cc = (ch & 15) * 8;
            const int R = R0 + ks * kBK + rr;
            const bool ok = R < R1;
            const int Rc = ok ? R : R0;
            const int bq = Rc / t_out, t = Rc % t_out;
            cp_async16_zfill(As + (slot * kBK + rr) * kWLd + cc,
                             hsrc + ((size_t)bq * th + 2 * t + p) * C + m0 + cc, ok);
            cp_async16_zfill(Bs + (slot * kBK + rr) * kWLd + cc,
                             g + ((size_t)bq * t_out + t) * C + n0 + cc, ok);
        }
    };

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < nk) copy(s);
        cp_async_commit();
    }
    for (int ks = 0; ks < nk; ++ks) {
        cp_async_wait<kStages - 2>();
        __syncthreads();
        if (ks + kStages - 1 < nk) copy(ks + kStages - 1);
        cp_async_commit();
        const __nv_bfloat16* At = As + (ks % kStages) * kBK * kWLd;
        const __nv_bfloat16* Bt = Bs + (ks % kStages) * kBK * kWLd;
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16) {
            uint32_t af[2][4];  // A[m = in][k = row] from rows k of H: transposed
#pragma unroll
            for (int i = 0; i < 2; ++i)
                ldmatrix_x4_trans(af[i], At + (kk + (mat >> 1) * 8 + (lane & 7)) * kWLd +
                                             wm * 32 + i * 16 + (mat & 1) * 8);
#pragma unroll
            for (int jp = 0; jp < 4; ++jp) {
                uint32_t bf[4];
                ldmatrix_x4_trans(bf, Bt + (kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * kWLd
                                          + wn * 64 + jp * 16 + 8 * (lane >> 4));
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    mma_bf16(acc[i][2 * jp], af[i], bf[0], bf[1]);
                    mma_bf16(acc[i][2 * jp + 1], af[i], bf[2], bf[3]);
                }
            }
        }
    }

    const int gq = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int m = m0 + wm * 32 + i * 16 + gq + 8 * e;
            float* dst = dw + ((size_t)p * C + m) * C + n0 + wn * 64 + c2;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                atomicAdd(dst + j * 8, acc[i][j][2 * e]);
                atomicAdd(dst + j * 8 + 1, acc[i][j][2 * e + 1]);
            }
        }
    }
}

constexpr size_t kDxSmem = (size_t)kStages * (kBM + kBN) * kALd * sizeof(__nv_bfloat16) +
                           2 * kBN * sizeof(float);
constexpr size_t kDwSmem = (size_t)kStages * 2 * kBK * kWLd * sizeof(__nv_bfloat16);

int grid_for(size_t n_vec) {
    const size_t blocks = (n_vec + 255) / 256;
    return (int)(blocks < 132 * 16 ? blocks : 132 * 16);
}

template <bool kAffine, bool kGeluIn>
cudaError_t launch_bwd(const void* x, const void* w, const void* a, const void* bb,
                       const void* gsrc, void* h_buf, void* dx, void* dw, void* da, void* db,
                       int B, int ts, int valid, int t_out, int C, int k, cudaStream_t stream) {
    const __nv_bfloat16* hsrc = (const __nv_bfloat16*)x;
    int th = ts;
    if (kAffine || kGeluIn) {
        const cudaError_t err = launch_h(x, a, bb, h_buf, B, ts, valid, C, kGeluIn, stream);
        if (err != cudaSuccess) return err;
        hsrc = (const __nv_bfloat16*)h_buf;
        th = valid;
    }
    auto dx_kernel = conv_bwd_dx_kernel<kAffine, kGeluIn>;
    cudaError_t err = cudaFuncSetAttribute(
        dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDxSmem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        conv_bwd_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDwSmem);
    if (err != cudaSuccess) return err;
    const dim3 gdx(((ts + 1) / 2 + kBM - 1) / kBM, C / kBN, 2 * B);
    dx_kernel<<<gdx, kThreads, kDxSmem, stream>>>(
        (const __nv_bfloat16*)gsrc, (const __nv_bfloat16*)w, (const __nv_bfloat16*)x,
        (const float*)a, (const float*)bb, (__nv_bfloat16*)dx, (float*)da, (float*)db,
        ts, valid, t_out, C, k);
    // split the B * t_out contraction so the card gets ~4 blocks per SM
    const int total_rows = B * t_out;
    const int tiles = k * (C / kBM) * (C / kBN);
    int splits = (4 * 132 + tiles - 1) / tiles;
    const int max_splits = (total_rows + kBK - 1) / kBK;
    splits = splits < 1 ? 1 : (splits > max_splits ? max_splits : splits);
    int rows_per_split = (total_rows + splits - 1) / splits;
    rows_per_split = (rows_per_split + kBK - 1) / kBK * kBK;
    splits = (total_rows + rows_per_split - 1) / rows_per_split;
    const dim3 gdw(C / kBM, C / kBN, k * splits);
    conv_bwd_dw_kernel<<<gdw, kThreads, kDwSmem, stream>>>(
        hsrc, (const __nv_bfloat16*)gsrc, (float*)dw, th, t_out, C, k, rows_per_split,
        total_rows);
    return cudaGetLastError();
}

// ------------------------------------------------------------------ forward

constexpr int kFM = 128;             // output rows per block (two warpgroups of 64)
constexpr int kFN = 256;             // output channels per block
constexpr int kFK = 64;              // K step: one 128-byte swizzled row of bf16
constexpr int kFStages = 4;
constexpr int kFThreads = 384;       // consumer warpgroups 0, 1; producer warpgroup 2
constexpr uint32_t kFABytes = kFM * kFK * 2;  // 16 KB
constexpr uint32_t kFBBytes = kFN * kFK * 2;  // 32 KB
constexpr size_t kFSmem = 1024 + (size_t)kFStages * (kFABytes + kFBBytes) + 2 * kFStages * 8;

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
    unsigned char* sB = smem + kFStages * kFABytes;       // [stage][256 rows][128 B]
    uint64_t* full = reinterpret_cast<uint64_t*>(sB + kFStages * kFBBytes);
    uint64_t* empty = full + kFStages;

    const int n0 = blockIdx.x * kFN, m0 = blockIdx.y * kFM, b = blockIdx.z;
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
                usk::mbar_expect_tx(&full[s], kFABytes + kFBBytes);
                const int kk = ks * kFK, tap = kk / C, c0 = kk % C;
                // tap 0: even row t, tap 1: odd row t, tap 2: even row t + 1
                usk::tma_load_3d(sA + s * kFABytes, tap == 1 ? &maps.odd : &maps.even, &full[s],
                                 c0, m0 + (tap >> 1), b);
                usk::tma_load_2d(sB + s * kFBBytes, &maps.w, &full[s], kk, n0);
            }
        }
    } else {  // consumers: rows m0 + 64 * wg ...
        usk::reg_alloc<232>();
        float acc[kFN / 2];
#pragma unroll
        for (int i = 0; i < kFN / 2; ++i) acc[i] = 0.f;
        for (int ks = 0; ks < nk; ++ks) {
            const int s = ks % kFStages;
            usk::mbar_wait(&full[s], (ks / kFStages) & 1);
            const unsigned char* a = sA + s * kFABytes + wg * 64 * 128;
            const unsigned char* bt = sB + s * kFBBytes;
            usk::fence_regs(acc);
            usk::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kFK / 16; ++kk)
                usk::wgmma_m64n256k16_ss<0, 0>(acc, usk::desc_sw128(a + kk * 32, 16, 1024),
                                               usk::desc_sw128(bt + kk * 32, 16, 1024));
            usk::wgmma_commit();
            usk::wgmma_wait<1>();  // the previous step's products are done
            usk::fence_regs(acc);
            if (ks > 0 && tid == 0) usk::mbar_arrive(&empty[(ks - 1) % kFStages]);
        }
        usk::wgmma_wait<0>();
        usk::fence_regs(acc);

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
            for (int j = 0; j < kFN / 8; ++j) {
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
    const uint64_t row2 = (uint64_t)2 * C * 2, batch = (uint64_t)ts * C * 2;
    const uint64_t even_dims[3] = {(uint64_t)C, (uint64_t)(ts + 1) / 2, (uint64_t)B};
    const uint64_t odd_dims[3] = {(uint64_t)C, (uint64_t)ts / 2, (uint64_t)B};
    const uint64_t a_strides[2] = {row2, batch};
    const uint32_t a_box[3] = {kFK, kFM, 1};
    const uint64_t w_dims[2] = {(uint64_t)k * C, (uint64_t)C};
    const uint64_t w_strides[1] = {(uint64_t)k * C * 2};
    const uint32_t w_box[2] = {kFK, kFN};
    const __nv_bfloat16* x = (const __nv_bfloat16*)src;
    if (!usk::make_tensor_map(&maps.even, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, x, even_dims,
                              a_strides, a_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !usk::make_tensor_map(&maps.odd, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, x + C, odd_dims,
                              a_strides, a_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !usk::make_tensor_map(&maps.w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w_t, w_dims,
                              w_strides, w_box, CU_TENSOR_MAP_SWIZZLE_128B))
        return cudaErrorInvalidValue;
    auto kernel = gelu_out ? conv_gemm_kernel<true> : conv_gemm_kernel<false>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFSmem);
    if (err != cudaSuccess) return err;
    // channel tiles fastest: the tiles sharing an A row block run together
    const dim3 grid((C + kFN - 1) / kFN, (t_out + kFM - 1) / kFM, B);
    kernel<<<grid, kFThreads, kFSmem, stream>>>(maps, (__nv_bfloat16*)y, (__nv_bfloat16*)pre,
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
                                       int k, int gelu_in, void* stream) {
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
        case 0: return (int)launch_bwd<false, false>(x, w, a, b, gsrc, h_buf, dx, dw, da, db, B, ts, valid, t_out, C, k, s);
        case 1: return (int)launch_bwd<false, true>(x, w, a, b, gsrc, h_buf, dx, dw, da, db, B, ts, valid, t_out, C, k, s);
        case 2: return (int)launch_bwd<true, false>(x, w, a, b, gsrc, h_buf, dx, dw, da, db, B, ts, valid, t_out, C, k, s);
        default: return (int)launch_bwd<true, true>(x, w, a, b, gsrc, h_buf, dx, dw, da, db, B, ts, valid, t_out, C, k, s);
    }
}
