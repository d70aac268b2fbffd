// First waveform conv layer + GroupNorm statistics, in one pass.
//
// Replaces unispeech_tpu/ops/pallas/l1_frontend.py::_fwd_kernel (launched by
// _run_fwd): conv1d(1 -> C, k taps, stride s) of the bf16-rounded waveform,
// fp32 accumulation, bf16 output, plus the per-(batch, channel) fp32 sum and
// sum of squares of the bf16-rounded outputs.
//
// Bound on the H100: bytes. At WavLM-Base+ width the output is the largest
// tensor of the model (B x 51,199 x 512 bf16 = 210 MB at 4 x 16 s) while the
// input is a 4 MB waveform and the arithmetic is 10 FMAs per output, so the
// kernel is the y1 write. Design: one block per (128-row tile, utterance);
// the tile's samples are staged once in shared memory (rounded to bf16 there),
// each thread owns two adjacent channels with their taps in registers and
// writes them as one bf16x2, so a warp stores 128 contiguous bytes per row.
// The statistics ride along in registers and cost no extra pass over y1:
// each thread adds its tile's partial sums to the (B, C) totals with fp32
// atomics (one per thread and statistic), so the summation order across
// tiles varies from run to run within fp32 rounding.
//
// Backward (l1_conv_bwd_kernel) replaces ::_bwd_kernel (launched by
// _run_bwd): the kernel's gradient through y1 and both sums,
//   dy1 = bf16(dy + ds1 + 2 * ds2 * y1),  dW[j, c] = sum_{b, t < t1} x[b, t*s + j] * dy1,
// with y1 recomputed exactly as the forward computes it (same taps, same
// fp32 order, rounded to bf16). Bound on the H100: bytes, the read of dy
// (6 x 49,167 x 512 bf16 = 302 MB at the pretraining batch, 90 us at
// 3.35 TB/s); the recompute and the accumulation are 4k fp32 FMAs per
// thread and row. Design: the forward's layout (one block per (256-row
// tile, utterance), samples staged in shared memory, two channels per
// thread with their taps and 2k dW partial sums in registers), dy read as
// bf16x2 four rows ahead; 256-row tiles give ~1,150 blocks at the
// pretraining batch, so eight blocks per SM keep their loads in flight.
// Rows past t1 never enter. Each block adds its (k, C) partial sums to the
// fp32 dW with atomics, so dW's summation order across tiles varies from run
// to run within fp32 rounding. The sums' terms are added without FMA contraction
// (__fadd_rn/__fmul_rn) in the plain version's order, so dy1 rounds to the
// same bf16 value as there.

#include "common.cuh"

namespace {

constexpr int kTile = 128;  // output rows per block
constexpr int kMaxTaps = 16;  // k <= 2 * stride <= 16

__global__ void __launch_bounds__(1024) l1_conv_stats_kernel(
    const float* __restrict__ wav,         // (B, ns) fp32
    const __nv_bfloat16* __restrict__ w,   // (k, C) bf16
    __nv_bfloat16* __restrict__ y,         // (B, t1, C) bf16
    float* __restrict__ s1,                // (B, C) fp32, zeroed
    float* __restrict__ s2,                // (B, C) fp32, zeroed
    int ns, int t1, int C, int k, int stride) {
    extern __shared__ float xs[];  // (rows - 1) * stride + k samples
    const int b = blockIdx.y;
    const int t0 = blockIdx.x * kTile;
    const int rows = min(kTile, t1 - t0);
    const int nsamp = (rows - 1) * stride + k;
    const float* src = wav + (size_t)b * ns + (size_t)t0 * stride;
    for (int i = threadIdx.x; i < nsamp; i += blockDim.x)
        xs[i] = usk::round_bf16(src[i]);

    const int c = 2 * threadIdx.x;
    float w0[kMaxTaps], w1[kMaxTaps];
#pragma unroll
    for (int j = 0; j < kMaxTaps; ++j) {
        w0[j] = j < k ? usk::bf2f(w[j * C + c]) : 0.f;
        w1[j] = j < k ? usk::bf2f(w[j * C + c + 1]) : 0.f;
    }
    __syncthreads();

    float sum0 = 0.f, sum1 = 0.f, sq0 = 0.f, sq1 = 0.f;
    __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(
        y + ((size_t)b * t1 + t0) * C + c);
    for (int r = 0; r < rows; ++r) {
        const float* xr = xs + r * stride;
        float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxTaps; ++j) {
            if (j < k) {
                const float xv = xr[j];
                acc0 = fmaf(w0[j], xv, acc0);
                acc1 = fmaf(w1[j], xv, acc1);
            }
        }
        const __nv_bfloat162 o = __floats2bfloat162_rn(acc0, acc1);
        out[(size_t)r * (C / 2)] = o;
        const float2 of = __bfloat1622float2(o);
        sum0 += of.x;
        sq0 = fmaf(of.x, of.x, sq0);
        sum1 += of.y;
        sq1 = fmaf(of.y, of.y, sq1);
    }
    float* p1 = s1 + (size_t)b * C + c;
    float* p2 = s2 + (size_t)b * C + c;
    atomicAdd(p1, sum0);
    atomicAdd(p1 + 1, sum1);
    atomicAdd(p2, sq0);
    atomicAdd(p2 + 1, sq1);
}

constexpr int kBwdTile = 256;  // rows per block of the backward
constexpr int kUnroll = 4;      // dy rows loaded ahead

__global__ void __launch_bounds__(512) l1_conv_bwd_kernel(
    const float* __restrict__ wav,         // (B, ns) fp32
    const __nv_bfloat16* __restrict__ w,   // (k, C) bf16
    const __nv_bfloat16* __restrict__ dy,  // (B, t1, C) bf16
    const float* __restrict__ ds1,         // (B, C) or null
    const float* __restrict__ ds2,         // (B, C) or null
    float* __restrict__ dw,                // (k, C) fp32, zeroed
    int ns, int t1, int C, int k, int stride) {
    extern __shared__ float xs[];
    const int b = blockIdx.y;
    const int t0 = blockIdx.x * kBwdTile;
    const int rows = min(kBwdTile, t1 - t0);
    const int nsamp = (rows - 1) * stride + k;
    const float* src = wav + (size_t)b * ns + (size_t)t0 * stride;
    for (int i = threadIdx.x; i < nsamp; i += blockDim.x)
        xs[i] = usk::round_bf16(src[i]);

    const int c = 2 * threadIdx.x;
    float w0[kMaxTaps], w1[kMaxTaps], g0[kMaxTaps], g1[kMaxTaps];
#pragma unroll
    for (int j = 0; j < kMaxTaps; ++j) {
        w0[j] = j < k ? usk::bf2f(w[j * C + c]) : 0.f;
        w1[j] = j < k ? usk::bf2f(w[j * C + c + 1]) : 0.f;
        g0[j] = g1[j] = 0.f;
    }
    const float a0 = ds1 ? ds1[(size_t)b * C + c] : 0.f;
    const float a1 = ds1 ? ds1[(size_t)b * C + c + 1] : 0.f;
    const float q0 = ds2 ? 2.f * ds2[(size_t)b * C + c] : 0.f;
    const float q1 = ds2 ? 2.f * ds2[(size_t)b * C + c + 1] : 0.f;
    __syncthreads();

    const __nv_bfloat162* drow = reinterpret_cast<const __nv_bfloat162*>(
        dy + ((size_t)b * t1 + t0) * C + c);
    for (int r0 = 0; r0 < rows; r0 += kUnroll) {
        __nv_bfloat162 d[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
            d[u] = drow[(size_t)min(r0 + u, rows - 1) * (C / 2)];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const int r = r0 + u;
            if (r >= rows) break;
            const float* xr = xs + r * stride;
            const float2 df = __bfloat1622float2(d[u]);
            float d0 = df.x, d1 = df.y;
            if (ds1) {
                d0 = __fadd_rn(d0, a0);
                d1 = __fadd_rn(d1, a1);
            }
            if (ds2) {  // y1 exactly as the forward computes it
                float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
                for (int j = 0; j < kMaxTaps; ++j) {
                    if (j < k) {
                        acc0 = fmaf(w0[j], xr[j], acc0);
                        acc1 = fmaf(w1[j], xr[j], acc1);
                    }
                }
                const float2 y = __bfloat1622float2(__floats2bfloat162_rn(acc0, acc1));
                d0 = __fadd_rn(d0, __fmul_rn(q0, y.x));
                d1 = __fadd_rn(d1, __fmul_rn(q1, y.y));
            }
            d0 = usk::round_bf16(d0);
            d1 = usk::round_bf16(d1);
#pragma unroll
            for (int j = 0; j < kMaxTaps; ++j) {
                if (j < k) {
                    g0[j] = fmaf(xr[j], d0, g0[j]);
                    g1[j] = fmaf(xr[j], d1, g1[j]);
                }
            }
        }
    }
#pragma unroll
    for (int j = 0; j < kMaxTaps; ++j) {
        if (j < k) {
            atomicAdd(dw + (size_t)j * C + c, g0[j]);
            atomicAdd(dw + (size_t)j * C + c + 1, g1[j]);
        }
    }
}

}  // namespace

extern "C" int usk_l1_conv_stats(const void* wav, const void* w, void* y,
                                 void* s1, void* s2, int B, int ns, int t1,
                                 int C, int k, int stride, void* stream) {
    const dim3 grid((t1 + kTile - 1) / kTile, B);
    const size_t smem = ((kTile - 1) * stride + k) * sizeof(float);
    l1_conv_stats_kernel<<<grid, C / 2, smem, (cudaStream_t)stream>>>(
        (const float*)wav, (const __nv_bfloat16*)w, (__nv_bfloat16*)y,
        (float*)s1, (float*)s2, ns, t1, C, k, stride);
    return (int)cudaGetLastError();
}

extern "C" int usk_l1_conv_bwd(const void* wav, const void* w, const void* dy,
                               const void* ds1, const void* ds2, void* dw, int B, int ns,
                               int t1, int C, int k, int stride, void* stream) {
    const dim3 grid((t1 + kBwdTile - 1) / kBwdTile, B);
    const size_t smem = ((kBwdTile - 1) * stride + k) * sizeof(float);
    l1_conv_bwd_kernel<<<grid, C / 2, smem, (cudaStream_t)stream>>>(
        (const float*)wav, (const __nv_bfloat16*)w, (const __nv_bfloat16*)dy,
        (const float*)ds1, (const float*)ds2, (float*)dw, ns, t1, C, k, stride);
    return (int)cudaGetLastError();
}

extern "C" const char* usk_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
