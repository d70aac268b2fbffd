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

extern "C" const char* usk_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
