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
