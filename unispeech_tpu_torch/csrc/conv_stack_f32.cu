// Fused strided-conv1d + GELU block of the waveform frontend, forward, in fp32.
//
// Replaces unispeech_tpu/ops/pallas/conv_stack.py::_fwd_kernel
// (launched by _run_fwd) at fp32, the models' default dtype:
//   H = gelu_in?(x * a[b] + b[b])          (the H pass; only with either)
//   pre[b, t] = sum_{p < k} H[b, 2t + p] . W[p]   (k in {2, 3}, stride 2)
//   y = gelu_out?(pre)
// with exact erf GELU, all in fp32, and pre written too when asked (the
// autograd forward saves it).
//
// Bound on the H100: operations. At WavLM-Base+ width (C = 512) the six
// blocks of a 4 x 16 s forward are 311.5 GFLOP: 4.65 ms at the 67 TFLOP/s
// of fp32 FMA, 0.63 ms as one TF32 pass at 495 TFLOP/s. One TF32 pass keeps
// 11 bits of each operand, which is not fp32; this kernel runs the 3xTF32
// split (tf32.cuh), three tensor-core products per fragment, 1.89 ms at the
// TF32 peak, against 1.26 GB moved (0.38 ms).
// Design: y is the GEMM (B t_out, k C) x (k C, C): row (b, t) of its left
// operand is the k C contiguous floats of H from row 2t of utterance b (the
// stride-2 windows overlap in place, no im2col copy), its right operand the
// (k, C_in, C_out) kernel as it lies, row-major. A block of 8 warps computes
// a 128 x 128 tile of y with mma.sync.m16n8k8 (each warp 64 x 32); the
// operands arrive by 16-byte cp.async into a 3-stage ring of 16-deep K
// slices, in row strides padded so every fragment read is free of bank
// conflicts. Each fragment is split into hi + lo when read from shared
// memory. The epilogue applies the output GELU and stores y (and pre) with
// 8-byte stores. wgmma takes TF32 only with both operands K-major, which
// this right operand is not; a faster design is later work.
//
// Backward: replaces ::_bwd_kernel (launched by _run_bwd) at fp32. With
// g = gelu'(pre) * dy (g = dy without the output GELU), x^ = x * a + b (or
// x) and H = gelu_in?(x^):
//   dX^[2t + p] = sum over taps p of g[t] . W_p^T;  dX^ *= gelu'(x^) if gelu_in;
//   da = sum_t dX^ * x, db = sum_t dX^;  dx = dX^ * a (or dX^), zero from valid on
//   dW_p = sum_{b, t < t_out} H[b, 2t + p]^T . g[b, t]
// in fp32, gelu' the exact erf derivative. Bound on the H100: operations;
// at the WavLM-Base pretraining batch (6 x 245,840 samples) dx and dW of
// the six blocks are 899 GFLOP, 2.7 TFLOP as 3xTF32: 5.45 ms at the TF32
// peak, against ~3.5 GB moved (1.0 ms). Four launches, as the bf16 kernels
// (so one launch count serves both dtypes):
//   conv_bwd_g_f32_kernel  g (elementwise; only with the output GELU)
//   conv_h_f32_kernel      H (the forward's pass; only with affine or gelu_in)
//   conv_bwd_dx_f32_kernel dX^ for the input rows of one parity per
//                          blockIdx.z: rows r = 2t' + par, parity 0 over
//                          taps 0 (g row t') and 2 (g row t' - 1), parity 1
//                          over tap 1 (g row t'), K = taps x C_out; A = g
//                          rows (rows outside [0, t_out) load as zeros), B =
//                          W_p read as stored ([tap][in][out], K contiguous);
//                          the epilogue applies gelu'(x^) (x^ recomputed from
//                          x and the affine), adds da/db by one shuffle tree
//                          over the warp's rows and one fp32 atomic per
//                          column and warp, scales by a and stores dx, zero
//                          on the rows from valid to the input's end
//   conv_bwd_dw_f32_kernel dW_p, split-K over the B t_out rows: A = H rows
//                          2t + p and B = g rows, both channel-contiguous
//                          ([row][channel] tiles in shared memory, read as
//                          the transposed operand); each block adds its
//                          128 x 128 tile into dW by fp32 atomics
// Both GEMMs are the forward GEMM's shape (128 x 128 tiles, 8 warps of
// mma.sync 3xTF32, a 3-stage cp.async ring of 16-deep K slices). The fp32
// sums of dW over splits and of da/db over row tiles vary in order from run
// to run within fp32 rounding.

#include "common.cuh"
#include "tf32.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 16;
constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kAStride = kBK + 4;  // floats per A row in shared memory
constexpr int kBStride = kBN + 8;  // floats per B row
constexpr int kSmemFloats = kStages * (kBM * kAStride + kBK * kBStride);
constexpr int kVec = 4;

// h = gelu_in?(x * a + b) over the valid rows, fp32, into (B, valid, C)
template <bool kAffine, bool kGeluIn>
__global__ void conv_h_f32_kernel(const float* __restrict__ x, const float* __restrict__ a,
                                  const float* __restrict__ bb, float* __restrict__ h, int ts,
                                  int valid, int C, size_t n_vec) {
    const int cv = C / kVec;
    for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n_vec;
         i += (size_t)gridDim.x * blockDim.x) {
        const size_t row = i / cv;  // over (B, valid)
        const int c4 = (int)(i % cv);
        const size_t b = row / valid, t = row % valid;
        float4 v = *reinterpret_cast<const float4*>(x + (b * ts + t) * C + kVec * c4);
        float e[4] = {v.x, v.y, v.z, v.w};
        if (kAffine) {
            const float4 av = *reinterpret_cast<const float4*>(a + b * C + kVec * c4);
            const float4 bv = *reinterpret_cast<const float4*>(bb + b * C + kVec * c4);
            const float ae[4] = {av.x, av.y, av.z, av.w}, be[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) e[j] = __fadd_rn(__fmul_rn(e[j], ae[j]), be[j]);
        }
        if (kGeluIn) {
#pragma unroll
            for (int j = 0; j < 4; ++j) e[j] = usk::gelu_erf(e[j]);
        }
        *reinterpret_cast<float4*>(h + row * C + kVec * c4) = make_float4(e[0], e[1], e[2], e[3]);
    }
}

template <bool kGelu, bool kPre>
__global__ void __launch_bounds__(kThreads) conv_gemm_f32_kernel(
    const float* __restrict__ h,  // (B, rows, C)
    const float* __restrict__ w,  // (k C, C)
    float* __restrict__ y,        // (B t_out, C)
    float* __restrict__ pre,      // (B t_out, C) (kPre)
    int rows, int t_out, int M, int C, int K) {
    extern __shared__ float4 conv_f32_smem[];
    float* As = reinterpret_cast<float*>(conv_f32_smem);
    float* Bs = As + kStages * kBM * kAStride;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, tq = lane & 3;
    const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
    const int wm = warp / 4, wn = warp % 4;  // the warp's 64 x 32 tile

    // this thread's copies: A rows tid / 4 and + 64 (chunk tid % 4 of a
    // 16-float slice), B rows tid / 32 and + 8 (chunk tid % 32 of 128)
    const float* a_src[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int m = min(m0 + tid / 4 + 64 * i, M - 1);  // rows past M: any row, not stored
        const int b = m / t_out, t = m % t_out;
        a_src[i] = h + ((size_t)b * rows + 2 * t) * C + 4 * (tid % 4);
    }
    const float* b_src = w + (size_t)(tid / 32) * C + n0 + 4 * (tid % 32);
    auto load = [&](int stage, int kt) {
        const int k0 = kt * kBK;
        float* as = As + stage * kBM * kAStride;
        float* bs = Bs + stage * kBK * kBStride;
#pragma unroll
        for (int i = 0; i < 2; ++i)
            usk::cp_async16(as + (tid / 4 + 64 * i) * kAStride + 4 * (tid % 4), a_src[i] + k0,
                            true);
#pragma unroll
        for (int i = 0; i < 2; ++i)
            usk::cp_async16(bs + (tid / 32 + 8 * i) * kBStride + 4 * (tid % 32),
                            b_src + (size_t)(k0 + 8 * i) * C, true);
    };

    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    const int KT = K / kBK;
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
        if (st < KT) load(st, st);
        usk::cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
        usk::cp_async_wait<kStages - 2>();
        __syncthreads();  // slice kt landed for all; slice kt - 1's stage is free
        const int nk = kt + kStages - 1;
        if (nk < KT) load(nk % kStages, nk);
        usk::cp_async_commit();
        const float* as = As + (kt % kStages) * kBM * kAStride + 64 * wm * kAStride;
        const float* bs = Bs + (kt % kStages) * kBK * kBStride + 32 * wn;
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 8) {
            uint32_t ah[4][4], al[4][4], bh[4][2], bl[4][2];
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
                const float* p = as + (16 * mt + g) * kAStride + kk + tq;
                usk::split_tf32(p[0], ah[mt][0], al[mt][0]);
                usk::split_tf32(p[8 * kAStride], ah[mt][1], al[mt][1]);
                usk::split_tf32(p[4], ah[mt][2], al[mt][2]);
                usk::split_tf32(p[8 * kAStride + 4], ah[mt][3], al[mt][3]);
            }
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                const float* p = bs + (kk + tq) * kBStride + 8 * nt + g;
                usk::split_tf32(p[0], bh[nt][0], bl[nt][0]);
                usk::split_tf32(p[4 * kBStride], bh[nt][1], bl[nt][1]);
            }
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
#pragma unroll
                for (int nt = 0; nt < 4; ++nt)
                    usk::mma_3xtf32(acc[mt][nt], ah[mt], al[mt], bh[nt][0], bh[nt][1], bl[nt][0],
                                    bl[nt][1]);
        }
    }

#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int hrow = 0; hrow < 2; ++hrow) {
            const int m = m0 + 64 * wm + 16 * mt + g + 8 * hrow;
            if (m >= M) continue;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                const int n = n0 + 32 * wn + 8 * nt + 2 * tq;
                const float v0 = acc[mt][nt][2 * hrow], v1 = acc[mt][nt][2 * hrow + 1];
                if (kPre)
                    *reinterpret_cast<float2*>(pre + (size_t)m * C + n) = make_float2(v0, v1);
                *reinterpret_cast<float2*>(y + (size_t)m * C + n) =
                    kGelu ? make_float2(usk::gelu_erf(v0), usk::gelu_erf(v1))
                          : make_float2(v0, v1);
            }
        }
}

template <bool kGelu, bool kPre>
cudaError_t launch_gemm(const void* h, const void* w, void* y, void* pre, int rows, int t_out,
                        int M, int C, int k, cudaStream_t st) {
    auto kernel = conv_gemm_f32_kernel<kGelu, kPre>;
    const int smem = kSmemFloats * (int)sizeof(float);
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((M + kBM - 1) / kBM, C / kBN);
    kernel<<<grid, kThreads, smem, st>>>((const float*)h, (const float*)w, (float*)y,
                                         (float*)pre, rows, t_out, M, C, k * C);
    return cudaGetLastError();
}

// g = gelu'(pre) * dy, elementwise (16-byte vectors)
__global__ void __launch_bounds__(256) conv_bwd_g_f32_kernel(const float* __restrict__ dy,
                                                             const float* __restrict__ pre,
                                                             float* __restrict__ g, size_t n_vec) {
    for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n_vec;
         i += (size_t)gridDim.x * blockDim.x) {
        const float4 d = reinterpret_cast<const float4*>(dy)[i];
        const float4 p = reinterpret_cast<const float4*>(pre)[i];
        reinterpret_cast<float4*>(g)[i] =
            make_float4(__fmul_rn(usk::dgelu_erf(p.x), d.x), __fmul_rn(usk::dgelu_erf(p.y), d.y),
                        __fmul_rn(usk::dgelu_erf(p.z), d.z), __fmul_rn(usk::dgelu_erf(p.w), d.w));
    }
}

// dx of the input rows of parity blockIdx.z: rows t' of (b, t') = divmod(m,
// tp), input row r = 2 t' + par, tp = ceil(ts / 2) rounded up to whole
// 128-row tiles; a 128 x 128 tile of (rows, input channels)
template <bool kAffine, bool kGeluIn>
__global__ void __launch_bounds__(kThreads) conv_bwd_dx_f32_kernel(
    const float* __restrict__ g,   // (B, t_out, C)
    const float* __restrict__ w,   // (k, C_in, C_out)
    const float* __restrict__ x,   // (B, ts, C)
    const float* __restrict__ aa,  // (B, C) or null
    const float* __restrict__ ab,  // (B, C) or null
    float* __restrict__ dx,        // (B, ts, C)
    float* __restrict__ da,        // (B, C) zeroed, or null
    float* __restrict__ db,        // (B, C) zeroed, or null
    int ts, int valid, int t_out, int tp, int C, int k) {
    extern __shared__ float4 conv_f32_smem[];
    float* As = reinterpret_cast<float*>(conv_f32_smem);
    float* Bs = As + kStages * kBM * kAStride;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gq = lane >> 2, tq = lane & 3;
    const int par = blockIdx.z;
    const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
    const int wm = warp / 4, wn = warp % 4;  // the warp's 64 x 32 tile
    const int b = m0 / tp;  // a tile never spans two utterances (tp % 128 == 0)
    // taps of this parity: 0 (and 2), or 1; K = n_taps C
    const int n_taps = par == 0 ? (k == 3 ? 2 : 1) : 1;
    const int KT = n_taps * C / kBK;

    // this thread's copies: A rows tid / 4 and + 64 (chunk tid % 4 of a
    // 16-float slice of g), B rows (input channels) tid / 4 and + 64 (chunk
    // tid % 4 of 16 output channels of W_p)
    int trow[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) trow[i] = m0 - b * tp + tid / 4 + 64 * i;  // t'
    auto load = [&](int stage, int kt) {
        const int kk = kt * kBK, tap_i = kk / C, c0 = kk % C;
        const int p = par == 0 ? 2 * tap_i : 1;  // tap 0, then tap 2
        float* as = As + stage * kBM * kAStride;
        float* bs = Bs + stage * kBN * kAStride;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int t = trow[i] - (p >> 1);  // the g row of tap p
            const bool ok = t >= 0 && t < t_out;
            usk::cp_async16(as + (tid / 4 + 64 * i) * kAStride + 4 * (tid % 4),
                            g + ((size_t)b * t_out + (ok ? t : 0)) * C + c0 + 4 * (tid % 4), ok);
            usk::cp_async16(bs + (tid / 4 + 64 * i) * kAStride + 4 * (tid % 4),
                            w + ((size_t)p * C + n0 + tid / 4 + 64 * i) * C + c0 + 4 * (tid % 4),
                            true);
        }
    };

    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
        if (st < KT) load(st, st);
        usk::cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
        usk::cp_async_wait<kStages - 2>();
        __syncthreads();
        const int nk = kt + kStages - 1;
        if (nk < KT) load(nk % kStages, nk);
        usk::cp_async_commit();
        const float* as = As + (kt % kStages) * kBM * kAStride + 64 * wm * kAStride;
        const float* bs = Bs + (kt % kStages) * kBN * kAStride + 32 * wn * kAStride;
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 8) {
            uint32_t ah[4][4], al[4][4], bh[4][2], bl[4][2];
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
                const float* p = as + (16 * mt + gq) * kAStride + kk + tq;
                usk::split_tf32(p[0], ah[mt][0], al[mt][0]);
                usk::split_tf32(p[8 * kAStride], ah[mt][1], al[mt][1]);
                usk::split_tf32(p[4], ah[mt][2], al[mt][2]);
                usk::split_tf32(p[8 * kAStride + 4], ah[mt][3], al[mt][3]);
            }
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                const float* p = bs + (8 * nt + gq) * kAStride + kk + tq;
                usk::split_tf32(p[0], bh[nt][0], bl[nt][0]);
                usk::split_tf32(p[4], bh[nt][1], bl[nt][1]);
            }
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
#pragma unroll
                for (int nt = 0; nt < 4; ++nt)
                    usk::mma_3xtf32(acc[mt][nt], ah[mt], al[mt], bh[nt][0], bh[nt][1], bl[nt][0],
                                    bl[nt][1]);
        }
    }

    // epilogue: element (mt, nt, e) is row t' = m0 - b tp + 64 wm + 16 mt + gq
    // + 8 (e >> 1), input channel n0 + 32 wn + 8 nt + 2 tq + (e & 1)
    float sa[4][2], sb[4][2];  // da / db partials of this lane's columns
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) sa[nt][0] = sa[nt][1] = sb[nt][0] = sb[nt][1] = 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + 32 * wn + 8 * nt + 2 * tq;
        float2 av = make_float2(1.f, 1.f), bv = make_float2(0.f, 0.f);
        if (kAffine) {
            av = *reinterpret_cast<const float2*>(aa + (size_t)b * C + n);
            bv = *reinterpret_cast<const float2*>(ab + (size_t)b * C + n);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int hrow = 0; hrow < 2; ++hrow) {
                const int t = m0 - b * tp + 64 * wm + 16 * mt + gq + 8 * hrow;
                const int r = 2 * t + par;
                if (r >= ts) continue;
                float* dst = dx + ((size_t)b * ts + r) * C + n;
                if (r >= valid) {
                    *reinterpret_cast<float2*>(dst) = make_float2(0.f, 0.f);
                    continue;
                }
                float v0 = acc[mt][nt][2 * hrow], v1 = acc[mt][nt][2 * hrow + 1];
                if (kAffine || kGeluIn) {
                    const float2 xv = *reinterpret_cast<const float2*>(x + ((size_t)b * ts + r) * C + n);
                    if (kGeluIn) {
                        // x^ as the H pass forms it: mul then add, each rounded
                        const float h0 = kAffine ? __fadd_rn(__fmul_rn(xv.x, av.x), bv.x) : xv.x;
                        const float h1 = kAffine ? __fadd_rn(__fmul_rn(xv.y, av.y), bv.y) : xv.y;
                        v0 = __fmul_rn(v0, usk::dgelu_erf(h0));
                        v1 = __fmul_rn(v1, usk::dgelu_erf(h1));
                    }
                    if (kAffine) {
                        sa[nt][0] = fmaf(v0, xv.x, sa[nt][0]);
                        sa[nt][1] = fmaf(v1, xv.y, sa[nt][1]);
                        sb[nt][0] += v0;
                        sb[nt][1] += v1;
                        v0 = __fmul_rn(v0, av.x);
                        v1 = __fmul_rn(v1, av.y);
                    }
                }
                *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
            }
    }
    if (kAffine) {
        // over the warp's 8 row lanes (gq), then one atomic per column and warp
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                float va = sa[nt][c], vb = sb[nt][c];
#pragma unroll
                for (int off = 4; off < 32; off <<= 1) {
                    va += __shfl_xor_sync(0xffffffffu, va, off);
                    vb += __shfl_xor_sync(0xffffffffu, vb, off);
                }
                if (gq == 0) {
                    const int n = n0 + 32 * wn + 8 * nt + 2 * tq + c;
                    atomicAdd(da + (size_t)b * C + n, va);
                    atomicAdd(db + (size_t)b * C + n, vb);
                }
            }
    }
}

// dW_p over the rows [split * per_split, +per_split) of the B t_out rows:
// A[ci][row] = H[b, 2t + p][ci], B[row][co] = g[b, t][co]; a 128 x 128 tile
// of (input, output channels) per block, added into dW by fp32 atomics
__global__ void __launch_bounds__(kThreads) conv_bwd_dw_f32_kernel(
    const float* __restrict__ h,  // (B, th, C)
    const float* __restrict__ g,  // (B, t_out, C)
    float* __restrict__ dw,       // (k, C, C) zeroed
    int th, int t_out, int total_rows, int per_split, int C, int k) {
    extern __shared__ float4 conv_f32_smem[];
    constexpr int kStride = kBM + 8;  // floats per K row of a [k][channel] tile
    float* As = reinterpret_cast<float*>(conv_f32_smem);
    float* Bs = As + kStages * kBK * kStride;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gq = lane >> 2, tq = lane & 3;
    const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
    const int p = blockIdx.z % k, split = blockIdx.z / k;
    const int row_lo = split * per_split;
    const int row_hi = min(total_rows, row_lo + per_split);
    const int wm = warp / 4, wn = warp % 4;
    const int KT = (row_hi - row_lo + kBK - 1) / kBK;

    // this thread's copies: K rows tid / 32 and + 8, chunk tid % 32 of 128 channels
    auto load = [&](int stage, int kt) {
        float* as = As + stage * kBK * kStride;
        float* bs = Bs + stage * kBK * kStride;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int kr = tid / 32 + 8 * i;
            const int row = row_lo + kt * kBK + kr;
            const bool ok = row < row_hi;
            const int rr = ok ? row : row_lo;
            const int b = rr / t_out, t = rr % t_out;
            usk::cp_async16(as + kr * kStride + 4 * (tid % 32),
                            h + ((size_t)b * th + 2 * t + p) * C + m0 + 4 * (tid % 32), ok);
            usk::cp_async16(bs + kr * kStride + 4 * (tid % 32),
                            g + ((size_t)b * t_out + t) * C + n0 + 4 * (tid % 32), ok);
        }
    };

    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
        if (st < KT) load(st, st);
        usk::cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
        usk::cp_async_wait<kStages - 2>();
        __syncthreads();
        const int nk = kt + kStages - 1;
        if (nk < KT) load(nk % kStages, nk);
        usk::cp_async_commit();
        const float* as = As + (kt % kStages) * kBK * kStride + 64 * wm;
        const float* bs = Bs + (kt % kStages) * kBK * kStride + 32 * wn;
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 8) {
            uint32_t ah[4][4], al[4][4], bh[4][2], bl[4][2];
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
                const float* q = as + (kk + tq) * kStride + 16 * mt + gq;
                usk::split_tf32(q[0], ah[mt][0], al[mt][0]);
                usk::split_tf32(q[8], ah[mt][1], al[mt][1]);
                usk::split_tf32(q[4 * kStride], ah[mt][2], al[mt][2]);
                usk::split_tf32(q[4 * kStride + 8], ah[mt][3], al[mt][3]);
            }
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                const float* q = bs + (kk + tq) * kStride + 8 * nt + gq;
                usk::split_tf32(q[0], bh[nt][0], bl[nt][0]);
                usk::split_tf32(q[4 * kStride], bh[nt][1], bl[nt][1]);
            }
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
#pragma unroll
                for (int nt = 0; nt < 4; ++nt)
                    usk::mma_3xtf32(acc[mt][nt], ah[mt], al[mt], bh[nt][0], bh[nt][1], bl[nt][0],
                                    bl[nt][1]);
        }
    }
    if (KT == 0) return;
    float* out = dw + (size_t)p * C * C;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int hrow = 0; hrow < 2; ++hrow) {
            const int m = m0 + 64 * wm + 16 * mt + gq + 8 * hrow;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                const int n = n0 + 32 * wn + 8 * nt + 2 * tq;
                atomicAdd(out + (size_t)m * C + n, acc[mt][nt][2 * hrow]);
                atomicAdd(out + (size_t)m * C + n + 1, acc[mt][nt][2 * hrow + 1]);
            }
        }
}

size_t grid_for(size_t n) {
    const size_t cap = (size_t)usk::sm_count() * 16;
    const size_t g = (n + 255) / 256;
    return g < cap ? g : cap;
}

}  // namespace

// x (B, ts, C) fp32 contiguous, 16-byte aligned; w (k, C, C) fp32
// contiguous (the JAX (k, in, out) layout); a / b (B, C) fp32 or null;
// h_buf (B, valid, C) fp32 when a or gelu_in, else null; y and pre
// (B, t_out, C) fp32, pre null unless wanted; C % 128 == 0, k in {2, 3}
extern "C" int usk_conv_gelu_block_f32(const void* x, const void* w, const void* a,
                                       const void* b, void* h_buf, void* y, void* pre, int B,
                                       int ts, int valid, int t_out, int C, int k, int gelu_in,
                                       int gelu_out, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (C % kBN != 0 || (k != 2 && k != 3)) return (int)cudaErrorInvalidValue;
    const void* src = x;
    int rows = ts;
    if (a != nullptr || gelu_in) {
        const size_t n_vec = (size_t)B * valid * C / kVec;
        const size_t grid = grid_for(n_vec);
        const float *xf = (const float*)x, *af = (const float*)a, *bf = (const float*)b;
        float* hf = (float*)h_buf;
        if (a != nullptr && gelu_in)
            conv_h_f32_kernel<true, true><<<grid, 256, 0, s>>>(xf, af, bf, hf, ts, valid, C, n_vec);
        else if (a != nullptr)
            conv_h_f32_kernel<true, false><<<grid, 256, 0, s>>>(xf, af, bf, hf, ts, valid, C, n_vec);
        else
            conv_h_f32_kernel<false, true><<<grid, 256, 0, s>>>(xf, af, bf, hf, ts, valid, C, n_vec);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        src = h_buf;
        rows = valid;
    }
    const int M = B * t_out;
    const int sel = (gelu_out ? 2 : 0) | (pre != nullptr ? 1 : 0);
    switch (sel) {
        case 0: return (int)launch_gemm<false, false>(src, w, y, pre, rows, t_out, M, C, k, s);
        case 1: return (int)launch_gemm<false, true>(src, w, y, pre, rows, t_out, M, C, k, s);
        case 2: return (int)launch_gemm<true, false>(src, w, y, pre, rows, t_out, M, C, k, s);
        default: return (int)launch_gemm<true, true>(src, w, y, pre, rows, t_out, M, C, k, s);
    }
}

namespace {

constexpr int kDxSmemFloats = kStages * 2 * kBM * kAStride;
constexpr int kDwSmemFloats = kStages * 2 * kBK * (kBM + 8);

template <bool kAffine, bool kGeluIn>
cudaError_t launch_dx_f32(const void* g, const void* w, const void* x, const void* a,
                          const void* b, void* dx, void* da, void* db, int B, int ts, int valid,
                          int t_out, int C, int k, cudaStream_t st) {
    auto kernel = conv_bwd_dx_f32_kernel<kAffine, kGeluIn>;
    const int smem = kDxSmemFloats * (int)sizeof(float);
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const int tp = (((ts + 1) / 2 + kBM - 1) / kBM) * kBM;
    const dim3 grid(B * tp / kBM, C / kBN, 2);
    kernel<<<grid, kThreads, smem, st>>>((const float*)g, (const float*)w, (const float*)x,
                                         (const float*)a, (const float*)b, (float*)dx,
                                         (float*)da, (float*)db, ts, valid, t_out, tp, C, k);
    return cudaGetLastError();
}

cudaError_t launch_dw_f32(const void* h, const void* g, void* dw, int B, int th, int t_out, int C,
                          int k, cudaStream_t st) {
    const int smem = kDwSmemFloats * (int)sizeof(float);
    const cudaError_t err = cudaFuncSetAttribute(
        conv_bwd_dw_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    // split the B t_out rows so the (tap, 128 x 128) tiles fill about two
    // waves of the card, at least 64 rows each
    const int total = B * t_out;
    const int tiles = k * (C / kBM) * (C / kBN);
    int splits = (2 * usk::sm_count() + tiles - 1) / tiles;
    splits = splits < 1 ? 1 : (splits > (total + 63) / 64 ? (total + 63) / 64 : splits);
    const int per_split = (total + splits - 1) / splits;
    splits = (total + per_split - 1) / per_split;
    const dim3 grid(C / kBM, C / kBN, k * splits);
    conv_bwd_dw_f32_kernel<<<grid, kThreads, smem, st>>>((const float*)h, (const float*)g,
                                                         (float*)dw, th, t_out, total, per_split,
                                                         C, k);
    return cudaGetLastError();
}

}  // namespace

// the block's backward in fp32: x (B, ts, C) contiguous, valid rows [0,
// valid); w (k, C, C) (the JAX (k, in, out) layout) contiguous; a / b (B, C)
// or null; dy, pre (B, t_out, C) (pre null without the output GELU); g_buf
// (B, t_out, C) scratch with pre; h_buf (B, valid, C) scratch with a or
// gelu_in; dx (B, ts, C); dw (k, C, C) zeroed; da / db (B, C) zeroed with
// a; parts: bit 1 dx, bit 2 dW; all fp32, 16-byte aligned; C % 128 == 0,
// k in {2, 3}
extern "C" int usk_conv_gelu_block_bwd_f32(const void* x, const void* w, const void* a,
                                           const void* b, const void* dy, const void* pre,
                                           void* g_buf, void* h_buf, void* dx, void* dw,
                                           void* da, void* db, int B, int ts, int valid,
                                           int t_out, int C, int k, int gelu_in, int parts,
                                           void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (C % kBN != 0 || (k != 2 && k != 3)) return (int)cudaErrorInvalidValue;
    const void* gsrc = dy;
    if (pre != nullptr) {
        const size_t n_vec = (size_t)B * t_out * C / kVec;
        conv_bwd_g_f32_kernel<<<grid_for(n_vec), 256, 0, s>>>((const float*)dy, (const float*)pre,
                                                              (float*)g_buf, n_vec);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        gsrc = g_buf;
    }
    const void* hsrc = x;
    int th = ts;
    if (a != nullptr || gelu_in) {
        const size_t n_vec = (size_t)B * valid * C / kVec;
        const size_t grid = grid_for(n_vec);
        const float *xf = (const float*)x, *af = (const float*)a, *bf = (const float*)b;
        float* hf = (float*)h_buf;
        if (a != nullptr && gelu_in)
            conv_h_f32_kernel<true, true><<<grid, 256, 0, s>>>(xf, af, bf, hf, ts, valid, C, n_vec);
        else if (a != nullptr)
            conv_h_f32_kernel<true, false><<<grid, 256, 0, s>>>(xf, af, bf, hf, ts, valid, C, n_vec);
        else
            conv_h_f32_kernel<false, true><<<grid, 256, 0, s>>>(xf, af, bf, hf, ts, valid, C, n_vec);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        hsrc = h_buf;
        th = valid;
    }
    if (parts & 1) {
        cudaError_t err;
        if (a != nullptr && gelu_in)
            err = launch_dx_f32<true, true>(gsrc, w, x, a, b, dx, da, db, B, ts, valid, t_out, C, k, s);
        else if (a != nullptr)
            err = launch_dx_f32<true, false>(gsrc, w, x, a, b, dx, da, db, B, ts, valid, t_out, C, k, s);
        else if (gelu_in)
            err = launch_dx_f32<false, true>(gsrc, w, x, a, b, dx, da, db, B, ts, valid, t_out, C, k, s);
        else
            err = launch_dx_f32<false, false>(gsrc, w, x, a, b, dx, da, db, B, ts, valid, t_out, C, k, s);
        if (err != cudaSuccess) return (int)err;
    }
    if (parts & 2) return (int)launch_dw_f32(hsrc, gsrc, dw, B, th, t_out, C, k, s);
    return (int)cudaSuccess;
}
