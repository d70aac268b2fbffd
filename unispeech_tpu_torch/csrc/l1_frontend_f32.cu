// First waveform conv layer + GroupNorm sums, in fp32.
//
// Replaces unispeech_tpu/ops/pallas/l1_frontend.py::_fwd_kernel (launched
// by _run_fwd) at dtype=float32, the models' default: conv1d(1 -> C, k
// taps, stride s) of the fp32 waveform with the fp32 (k, C) kernel, y1
// (B, t1, C) fp32, plus (kStats; stats=True, the `default` extractor) the
// per-(batch, channel) fp32 sum and sum of squares of y1 over its t1 rows;
// without them it writes y1 alone (the `layer_norm` extractor's call).
//
// Bound on the H100: bytes. y1 is the largest tensor of the model: 4 x
// 51,199 x 512 fp32 = 419 MB at 4 x 16 s (0.125 ms at 3.35 TB/s), against
// a 4.1 MB waveform and 10 fused multiply-adds per output element (2.1
// GFLOP: 31 us at the 67 TFLOP/s of the CUDA cores). So the products stay
// on the CUDA cores in fp32 (no tensor-core rounding at all) and the design
// is about the write.
// Design: a block of (C / 4) x ny threads (ny = 256 / (C / 4) rows at a
// time, at least 1) owns a contiguous run of rows of one utterance. Thread
// x owns channels 4x .. 4x + 3: their k taps sit in registers for the whole
// run. The run is cut into windows of kRows rows whose samples (kRows s +
// k - s) are staged in shared memory; every thread of a row reads the same
// sample (a broadcast), does 4k FMAs and writes its 4 outputs with one
// 16-byte streaming store, so a warp writes 512 contiguous bytes of a row.
// The sums stay in registers over the run, are added across the ny row
// lanes in shared memory at its end, and go out with one fp32 atomic per
// (channel, sum) and block: their summation order varies from run to run
// within fp32 rounding.
//
// Backward (l1_conv_bwd_f32_kernel) replaces ::_bwd_kernel (launched by
// _run_bwd) at fp32: the kernel's gradient through y1 and the sums,
//   dy1 = dy + ds1 + (2 ds2) y1,  dW[j, c] = sum_{b, t < t1} x[b, t s + j] dy1[b, t, c],
// in fp32 in the plain version's order (no contraction into FMAs), y1
// recomputed with the forward's FMAs only when ds2 is given (without the
// sums' cotangents, the layer_norm extractor's call, dy1 = dy). Bound on
// the H100: bytes, the read of dy (6 x 49,167 x 512 fp32 = 604 MB at the
// WavLM-Base pretraining batch, 0.18 ms at 3.35 TB/s), against 2k FMAs per
// dy element (4k with the recompute), below the CUDA cores' 67 TFLOP/s.
// Design: the forward's (threads own 4 channels, a block a run of rows of
// one utterance in windows of staged samples, every row one 16-byte load of
// dy per thread, coalesced along the channels), with the k x 4 dW partial
// sums in registers over the run; they are added across the block's row
// lanes in shared memory and go out with one fp32 atomic per (tap,
// channel) and block, so dW's summation order varies from run to run
// within fp32 rounding.

#include "common.cuh"

namespace {

constexpr int kRows = 64;      // rows per shared-memory window
constexpr int kMaxTaps = 16;   // k <= 2 stride <= 16
constexpr int kMaxC = 2048;
constexpr int kThreadsTarget = 256;

template <int kK, int kS, bool kStats>
__global__ void __launch_bounds__(512) l1_conv_fwd_f32_kernel(
    const float* __restrict__ wav,  // (B, ns)
    const float* __restrict__ w,    // (k, C)
    float* __restrict__ y,          // (B, t1, C)
    float* __restrict__ s1,         // (B, C), zeroed (kStats)
    float* __restrict__ s2,         // (B, C), zeroed (kStats)
    int ns, int t1, int C, int k_rt, int s_rt, int rows_per_block) {
    constexpr int kTaps = kK ? kK : kMaxTaps;
    const int k = kK ? kK : k_rt, s = kS ? kS : s_rt;
    __shared__ float win[kRows * 8 + kMaxTaps];
    __shared__ float red[kStats ? 2 * kMaxC : 1];
    const int cx = threadIdx.x, ry = threadIdx.y, ny = blockDim.y;
    const int tid = ry * blockDim.x + cx, nthreads = blockDim.x * ny;
    const int b = blockIdx.y;
    const int r_begin = blockIdx.x * rows_per_block;
    const int r_end = min(t1, r_begin + rows_per_block);

    float4 wr[kTaps];
#pragma unroll
    for (int j = 0; j < kTaps; ++j)
        wr[j] = (kK || j < k) ? *reinterpret_cast<const float4*>(w + (size_t)j * C + 4 * cx)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    float a1[4] = {0.f, 0.f, 0.f, 0.f}, a2[4] = {0.f, 0.f, 0.f, 0.f};
    const float* src = wav + (size_t)b * ns;

    for (int r0 = r_begin; r0 < r_end; r0 += kRows) {
        const int nr = min(kRows, r_end - r0);
        const int n_smp = (nr - 1) * s + k;
        __syncthreads();  // the previous window is consumed
        for (int i = tid; i < n_smp; i += nthreads) {
            const int g = r0 * s + i;
            win[i] = g < ns ? __ldg(src + g) : 0.f;
        }
        __syncthreads();
        for (int r = ry; r < nr; r += ny) {
            const float* x = win + r * s;
            float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int j = 0; j < kTaps; ++j) {
                if (!kK && j >= k) break;
                const float xv = x[j];
                acc.x = fmaf(xv, wr[j].x, acc.x);
                acc.y = fmaf(xv, wr[j].y, acc.y);
                acc.z = fmaf(xv, wr[j].z, acc.z);
                acc.w = fmaf(xv, wr[j].w, acc.w);
            }
            usk::st_stream(y + ((size_t)b * t1 + r0 + r) * C + 4 * cx,
                           make_uint4(__float_as_uint(acc.x), __float_as_uint(acc.y),
                                      __float_as_uint(acc.z), __float_as_uint(acc.w)));
            if (kStats) {
                const float v[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    a1[e] += v[e];
                    a2[e] = fmaf(v[e], v[e], a2[e]);
                }
            }
        }
    }
    if (!kStats) return;
    // the row lanes' sums of each channel, then one atomic per channel and sum
    for (int lane_y = 1; lane_y < ny; ++lane_y) {
        __syncthreads();
        if (ry == lane_y) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                red[4 * cx + e] = a1[e];
                red[kMaxC + 4 * cx + e] = a2[e];
            }
        }
        __syncthreads();
        if (ry == 0) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                a1[e] += red[4 * cx + e];
                a2[e] += red[kMaxC + 4 * cx + e];
            }
        }
    }
    if (ry == 0 && r_begin < r_end) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            atomicAdd(s1 + (size_t)b * C + 4 * cx + e, a1[e]);
            atomicAdd(s2 + (size_t)b * C + 4 * cx + e, a2[e]);
        }
    }
}

template <int kK, int kS>
cudaError_t launch_fwd_f32(const void* wav, const void* w, void* y, void* s1, void* s2, int B,
                           int ns, int t1, int C, int k, int stride, cudaStream_t st) {
    if (C % 64 != 0 || C > kMaxC || k > kMaxTaps || stride > 8) return cudaErrorInvalidValue;
    const int nx = C / 4;
    const int ny = nx >= kThreadsTarget ? 1 : kThreadsTarget / nx;
    // enough blocks to fill the card several times over, each a whole
    // number of windows of one utterance
    const int want_blocks = 8 * usk::sm_count();
    const int per_b = (want_blocks + B - 1) / B;
    int rows = (t1 + per_b - 1) / per_b;
    rows = ((rows + kRows - 1) / kRows) * kRows;
    const dim3 grid((t1 + rows - 1) / rows, B), block(nx, ny);
    if (s2 != nullptr)
        l1_conv_fwd_f32_kernel<kK, kS, true><<<grid, block, 0, st>>>(
            (const float*)wav, (const float*)w, (float*)y, (float*)s1, (float*)s2, ns, t1, C, k,
            stride, rows);
    else
        l1_conv_fwd_f32_kernel<kK, kS, false><<<grid, block, 0, st>>>(
            (const float*)wav, (const float*)w, (float*)y, nullptr, nullptr, ns, t1, C, k, stride,
            rows);
    return cudaGetLastError();
}

template <int kK, int kS, bool kRecompute>
__global__ void __launch_bounds__(256) l1_conv_bwd_f32_kernel(
    const float* __restrict__ wav,  // (B, ns)
    const float* __restrict__ w,    // (k, C), read with kRecompute
    const float* __restrict__ dy,   // (B, t1, C)
    const float* __restrict__ ds1,  // (B, C) or null
    const float* __restrict__ ds2,  // (B, C), null iff !kRecompute
    float* __restrict__ dw,         // (k, C), zeroed
    int ns, int t1, int C, int k_rt, int s_rt, int rows_per_block) {
    constexpr int kTaps = kK ? kK : kMaxTaps;
    const int k = kK ? kK : k_rt, s = kS ? kS : s_rt;
    __shared__ float win[kRows * 8 + kMaxTaps];
    __shared__ float4 red[kMaxC / 4];
    const int cx = threadIdx.x, ry = threadIdx.y, ny = blockDim.y;
    const int tid = ry * blockDim.x + cx, nthreads = blockDim.x * ny;
    const int b = blockIdx.y;
    const int r_begin = blockIdx.x * rows_per_block;
    const int r_end = min(t1, r_begin + rows_per_block);

    float4 wr[kRecompute ? kTaps : 1];
    if constexpr (kRecompute) {
#pragma unroll
        for (int j = 0; j < kTaps; ++j)
            wr[j] = (kK || j < k) ? *reinterpret_cast<const float4*>(w + (size_t)j * C + 4 * cx)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const float4 d1 = ds1 != nullptr ? *reinterpret_cast<const float4*>(ds1 + (size_t)b * C + 4 * cx)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 d2 = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (kRecompute) {
        d2 = *reinterpret_cast<const float4*>(ds2 + (size_t)b * C + 4 * cx);
        d2 = make_float4(2.f * d2.x, 2.f * d2.y, 2.f * d2.z, 2.f * d2.w);
    }
    float4 acc[kTaps];
#pragma unroll
    for (int j = 0; j < kTaps; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* src = wav + (size_t)b * ns;

    for (int r0 = r_begin; r0 < r_end; r0 += kRows) {
        const int nr = min(kRows, r_end - r0);
        const int n_smp = (nr - 1) * s + k;
        __syncthreads();  // the previous window is consumed
        for (int i = tid; i < n_smp; i += nthreads) {
            const int g = r0 * s + i;
            win[i] = g < ns ? __ldg(src + g) : 0.f;
        }
        __syncthreads();
        for (int r = ry; r < nr; r += ny) {
            const float* x = win + r * s;
            float4 d = __ldcs(reinterpret_cast<const float4*>(dy + ((size_t)b * t1 + r0 + r) * C) + cx);
            if (ds1 != nullptr)
                d = make_float4(__fadd_rn(d.x, d1.x), __fadd_rn(d.y, d1.y), __fadd_rn(d.z, d1.z),
                                __fadd_rn(d.w, d1.w));
            if constexpr (kRecompute) {
                float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
                for (int j = 0; j < kTaps; ++j) {
                    if (!kK && j >= k) break;
                    const float xv = x[j];
                    y.x = fmaf(xv, wr[j].x, y.x);
                    y.y = fmaf(xv, wr[j].y, y.y);
                    y.z = fmaf(xv, wr[j].z, y.z);
                    y.w = fmaf(xv, wr[j].w, y.w);
                }
                d = make_float4(__fadd_rn(d.x, __fmul_rn(d2.x, y.x)), __fadd_rn(d.y, __fmul_rn(d2.y, y.y)),
                                __fadd_rn(d.z, __fmul_rn(d2.z, y.z)), __fadd_rn(d.w, __fmul_rn(d2.w, y.w)));
            }
#pragma unroll
            for (int j = 0; j < kTaps; ++j) {
                if (!kK && j >= k) break;
                const float xv = x[j];
                acc[j].x = fmaf(xv, d.x, acc[j].x);
                acc[j].y = fmaf(xv, d.y, acc[j].y);
                acc[j].z = fmaf(xv, d.z, acc[j].z);
                acc[j].w = fmaf(xv, d.w, acc[j].w);
            }
        }
    }
    // the row lanes' sums of each (tap, channel), then one atomic each
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
        if (!kK && j >= k) break;
        for (int lane_y = 1; lane_y < ny; ++lane_y) {
            __syncthreads();
            if (ry == lane_y) red[cx] = acc[j];
            __syncthreads();
            if (ry == 0) {
                const float4 o = red[cx];
                acc[j] = make_float4(acc[j].x + o.x, acc[j].y + o.y, acc[j].z + o.z, acc[j].w + o.w);
            }
        }
        if (ry == 0 && r_begin < r_end) {
            float* dst = dw + (size_t)j * C + 4 * cx;
            atomicAdd(dst, acc[j].x);
            atomicAdd(dst + 1, acc[j].y);
            atomicAdd(dst + 2, acc[j].z);
            atomicAdd(dst + 3, acc[j].w);
        }
    }
}

template <int kK, int kS>
cudaError_t launch_bwd_f32(const void* wav, const void* w, const void* dy, const void* ds1,
                           const void* ds2, void* dw, int B, int ns, int t1, int C, int k,
                           int stride, cudaStream_t st) {
    if (C % 64 != 0 || C > kMaxC || k > kMaxTaps || stride > 8) return cudaErrorInvalidValue;
    const int nx = C / 4;
    const int ny = nx >= kThreadsTarget ? 1 : kThreadsTarget / nx;
    // a few blocks per SM, each a whole number of windows of one utterance:
    // every block adds its k C partial sums once
    const int want_blocks = 3 * usk::sm_count();
    const int per_b = (want_blocks + B - 1) / B;
    int rows = (t1 + per_b - 1) / per_b;
    rows = ((rows + kRows - 1) / kRows) * kRows;
    const dim3 grid((t1 + rows - 1) / rows, B), block(nx, ny);
    if (ds2 != nullptr)
        l1_conv_bwd_f32_kernel<kK, kS, true><<<grid, block, 0, st>>>(
            (const float*)wav, (const float*)w, (const float*)dy, (const float*)ds1,
            (const float*)ds2, (float*)dw, ns, t1, C, k, stride, rows);
    else
        l1_conv_bwd_f32_kernel<kK, kS, false><<<grid, block, 0, st>>>(
            (const float*)wav, (const float*)w, (const float*)dy, (const float*)ds1, nullptr,
            (float*)dw, ns, t1, C, k, stride, rows);
    return cudaGetLastError();
}

}  // namespace

// wav (B, ns) fp32 contiguous; w (k, C) fp32 contiguous, 16-byte aligned;
// y (B, t1, C) fp32 contiguous; s1 / s2 (B, C) fp32 zeroed, or both null
// (no sums); C % 64 == 0, C <= 2048, stride <= k <= 2 stride <= 16
extern "C" int usk_l1_conv_fwd_f32(const void* wav, const void* w, void* y, void* s1, void* s2,
                                   int B, int ns, int t1, int C, int k, int stride,
                                   void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (k == 10 && stride == 5)  // every configuration in configs.py
        return (int)launch_fwd_f32<10, 5>(wav, w, y, s1, s2, B, ns, t1, C, k, stride, st);
    return (int)launch_fwd_f32<0, 0>(wav, w, y, s1, s2, B, ns, t1, C, k, stride, st);
}

// wav (B, ns) fp32 contiguous; w (k, C) fp32 contiguous, 16-byte aligned
// (read only with ds2); dy (B, t1, C) fp32 contiguous, 16-byte aligned;
// ds1 / ds2 (B, C) fp32 contiguous or null; dw (k, C) fp32 zeroed; C % 64
// == 0, C <= 2048, stride <= k <= 2 stride <= 16
extern "C" int usk_l1_conv_bwd_f32(const void* wav, const void* w, const void* dy,
                                   const void* ds1, const void* ds2, void* dw, int B, int ns,
                                   int t1, int C, int k, int stride, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (k == 10 && stride == 5)  // every configuration in configs.py
        return (int)launch_bwd_f32<10, 5>(wav, w, dy, ds1, ds2, dw, B, ns, t1, C, k, stride, st);
    return (int)launch_bwd_f32<0, 0>(wav, w, dy, ds1, ds2, dw, B, ns, t1, C, k, stride, st);
}
