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
// with y1 recomputed from the same bf16 taps and samples. Bound on the
// H100: bytes, the read of dy (6 x 49,167 x 512 bf16 = 302 MB at the
// pretraining batch, 90 us at 3.35 TB/s). On CUDA cores the recompute and
// the sum are 2k fp32 FMAs per dy element, more than the bytes allow, so
// the design takes the JAX kernel's collapsed layout: the waveform as rows
// of s samples in 8 lanes makes both products K = 16 tensor-core products
// (mma.sync), and the CUDA cores only form dy1 (~7 operations per element,
// in the plain version's order without FMA contraction, so dy1 rounds as
// there unless the recomputed y1 itself rounds to the neighbouring bf16).
// dy arrives by TMA into a 6-stage ring of one persistent block per SM;
// each block adds its dW once, so dW's summation order across blocks
// varies from run to run within fp32 rounding.

#include "common.cuh"
#include "hopper.cuh"

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

// ---------------------------------------------------------------- backward

constexpr int kBwdMaxWarps = 16;  // consumer warps: (64-channel block, 16-row chunk) each
constexpr int kBwdThreads = 32 * (kBwdMaxWarps + 1);  // and one producer warp
constexpr int kBwdStages = 6;  // ring stages, fewer where six do not fit
constexpr int kXBox = 128;  // fp32 samples per TMA box of the waveform

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// packed tap p (0..15) -> tap of the (k, C) kernel, or -1: p < 8 is lane p
// of collapsed row t (tap p, p < s), p >= 8 lane p - 8 of row t + 1 (tap
// s + p - 8, p - 8 < k - s)
__device__ __forceinline__ int packed_tap(int p, int k, int s) {
    return p < 8 ? (p < s ? p : -1) : (p - 8 < k - s ? s + p - 8 : -1);
}

// dW[j, c] = sum over (b, t < t1) of x[b, t*s + j] * dy1[b, t, c],
// dy1 = bf16(dy + ds1 + 2 ds2 y1). Per block: a persistent walk over the
// (utterance, R-row tile) items, R = 16 rsplit. One producer thread keeps a
// ring of up to kBwdStages stages full by TMA: dy as C / 64 boxes of R rows
// x 64 channels (128-byte swizzle; rows past t1 zero-filled) and the tile's
// s R + 8 fp32 samples from sample s t0 (read from the 16-byte boundary
// before it, as boxes of a 1-D map over the flattened waveform). Each
// consumer warp owns one 64-channel block and one 16-row chunk of every
// tile. In the JAX kernel's collapsed layout, x2[t] = samples [s t, s t +
// 8), X2cat[t] = [x2[t], x2[t+1]] holds 16 packed taps and Wpack is the
// (16, C) packed kernel (zero at the packed taps that are not taps of the
// kernel), so Y1^T = Wpack^T . X2cat^T and dWpack^T += dY1^T . X2cat are
// mma.sync.m16n8k16 products, and the y1 accumulator is, after the
// elementwise dy1, the A fragment of the second product. The x fragments
// are read from the staged samples, rounded to bf16. dW stays in registers
// over the walk and is added once per block: shared-memory atomics across
// the block's warps, then k bulk reductions into the fp32 dW.
template <int kK, int kS, bool kRecompute>
__global__ void __launch_bounds__(kBwdThreads, 1) l1_conv_bwd_kernel(
    const __grid_constant__ CUtensorMap dy_map,  // (B, t1, C) bf16, boxes 64 x R x 1
    const __grid_constant__ CUtensorMap x_map,   // (B ns) fp32, boxes of kXBox
    const __nv_bfloat16* __restrict__ w,         // (k, C) bf16
    const float* __restrict__ ds1,               // (B, C) or null
    const float* __restrict__ ds2,               // (B, C), null iff !kRecompute
    float* __restrict__ dw,                      // (k, C) fp32, zeroed
    int ns, int t1, int C, int k_rt, int s_rt, int rsplit, int tiles_per_b, int n_tiles,
    int stage_bytes, int n_stages) {
    const int k = kK ? kK : k_rt, s = kS ? kS : s_rt;
    extern __shared__ unsigned char l1_smem_raw[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(l1_smem_raw) + 1023) & ~uintptr_t(1023));
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + n_stages * stage_bytes);
    uint64_t* empty = full + n_stages;
    const int nb = C / 64, R = 16 * rsplit, n_cons = nb * rsplit;
    const int dy_bytes = R * C * 2;
    const int x_boxes = (s * R + 11 + kXBox - 1) / kXBox;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (threadIdx.x == 0) {
        for (int st = 0; st < n_stages; ++st) {
            usk::mbar_init(&full[st], 1);
            usk::mbar_init(&empty[st], n_cons);
        }
        usk::fence_barrier_init();
    }
    __syncthreads();

    if (warp == n_cons) {  // producer
        if (lane == 0) {
            int it = 0;
            for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
                const int st = it % n_stages;
                const int b = tile / tiles_per_b, t0 = (tile % tiles_per_b) * R;
                unsigned char* sdy = smem + st * stage_bytes;
                usk::mbar_wait(&empty[st], ((it / n_stages) & 1) ^ 1);
                usk::mbar_expect_tx(&full[st], dy_bytes + x_boxes * kXBox * 4);
                for (int cb = 0; cb < nb; ++cb)
                    usk::tma_load_3d(sdy + cb * R * 128, &dy_map, &full[st], 64 * cb, t0, b);
                // from the 16-byte boundary at or before sample s t0 (a box
                // must start on one); samples past the utterance meet zero
                // taps or rows >= t1
                const int x0 = (b * ns + t0 * s) & ~3;
                for (int xb = 0; xb < x_boxes; ++xb)
                    usk::tma_load_1d(sdy + dy_bytes + xb * kXBox * 4, &x_map, &full[st],
                                     x0 + xb * kXBox);
            }
        }
        return;
    }

    const int cb = warp % nb, rc = warp / nb;
    const int g = lane >> 2, tq = lane & 3;
    // A fragments of Wpack^T (16 channels x 16 packed taps) of each 16-channel
    // m-tile, kept in shared memory (registers go to the accumulators)
    const int n_thr = 32 * n_cons;
    uint4* wfrag = reinterpret_cast<uint4*>(smem + n_stages * stage_bytes + 128);
    if (rc == 0) {
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
            uint32_t r4[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int c = 64 * cb + 16 * mt + g + 8 * (r & 1);
                float v[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int j = packed_tap(8 * (r >> 1) + 2 * tq + e, k, s);
                    v[e] = j >= 0 ? usk::bf2f(w[j * C + c]) : 0.f;
                }
                r4[r] = pack_bf16x2(v[0], v[1]);
            }
            wfrag[(cb * 4 + mt) * 32 + lane] = make_uint4(r4[0], r4[1], r4[2], r4[3]);
        }
    }
    usk::named_bar_sync(1, n_thr);
    float acc[4][2][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
    float a1[4][2], q2[4][2];  // ds1 and 2 ds2 of this lane's channels

    // ldmatrix row addresses of dy: rows 0-7 / 8-15 of the chunk at the
    // 16-byte channel chunks 2 mt / 2 mt + 1
    const int drow = 16 * rc + (lane & 7) + 8 * (lane >> 4);
    int it = 0, cur_b = -1;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
        const int st = it % n_stages;
        const int b = tile / tiles_per_b;
        const int valid = t1 - ((tile % tiles_per_b) * R + 16 * rc);  // rows of the chunk < t1
        if (b != cur_b) {
            cur_b = b;
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const size_t c = (size_t)b * C + 64 * cb + 16 * mt + g + 8 * h;
                    a1[mt][h] = ds1 ? ds1[c] : 0.f;
                    q2[mt][h] = kRecompute ? 2.f * ds2[c] : 0.f;
                }
        }
        usk::mbar_wait(&full[st], (it / n_stages) & 1);
        if (valid > 0) {
            const unsigned char* sdy = smem + st * stage_bytes + cb * R * 128;
            const float* smp = reinterpret_cast<const float*>(smem + st * stage_bytes + dy_bytes) +
                               ((b * ns + ((tile % tiles_per_b) * R) * s) & 3);
            // x fragments of the 8 x 8 matrices of collapsed rows 0-7, 1-8,
            // 8-15, 9-16 of the chunk: xb as read by rows (B of Y1^T), xt
            // transposed (B of dW)
            uint32_t xb[4], xt[4];
#pragma unroll
            for (int m = 0; m < 4; ++m) {
                const int r0 = 16 * rc + (m & 1) + 8 * (m >> 1);
                const float* p = smp + s * (r0 + g) + 2 * tq;
                const float* q = smp + s * (r0 + 2 * tq) + g;
                xb[m] = pack_bf16x2(p[0], p[1]);
                xt[m] = pack_bf16x2(q[0], q[s]);
            }
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
                uint32_t d[4];
                const int chunk = 2 * mt + ((lane >> 3) & 1);
                usk::ldmatrix_x4_trans(d, sdy + drow * 128 + ((chunk ^ (drow & 7)) << 4));
                float y[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
                if (kRecompute) {
                    const uint4 wv = wfrag[(cb * 4 + mt) * 32 + lane];
                    const uint32_t wa[4] = {wv.x, wv.y, wv.z, wv.w};
                    usk::mma_bf16_16816(y[0], wa, xb[0], xb[1]);
                    usk::mma_bf16_16816(y[1], wa, xb[2], xb[3]);
                }
                uint32_t af[4];  // dY1^T (16 channels x 16 rows), A-fragment order
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const int h = r & 1, n = r >> 1;
                    float2 f = unpack_bf16x2(d[r]);
                    f.x = __fadd_rn(f.x, a1[mt][h]);
                    f.y = __fadd_rn(f.y, a1[mt][h]);
                    if (kRecompute) {  // y1 rounded to bf16 as the forward stores it
                        const float2 yb = unpack_bf16x2(pack_bf16x2(y[n][2 * h], y[n][2 * h + 1]));
                        f.x = __fadd_rn(f.x, __fmul_rn(q2[mt][h], yb.x));
                        f.y = __fadd_rn(f.y, __fmul_rn(q2[mt][h], yb.y));
                    }
                    if (valid < 16) {
                        const int row = 8 * n + 2 * tq;
                        if (row >= valid) f.x = 0.f;
                        if (row + 1 >= valid) f.y = 0.f;
                    }
                    af[r] = pack_bf16x2(f.x, f.y);
                }
                usk::mma_bf16_16816(acc[mt][0], af, xt[0], xt[2]);  // taps 0-7: rows t
                usk::mma_bf16_16816(acc[mt][1], af, xt[1], xt[3]);  // taps 8-15: rows t + 1
            }
        }
        __syncwarp();
        if (lane == 0) usk::mbar_arrive(&empty[st]);
    }

    // the ring is free once every consumer is past its last stage: sum the
    // warps' (taps, channels) fragments there, then add them into dW
    float* sdw = reinterpret_cast<float*>(smem);  // (k, C)
    usk::named_bar_sync(1, n_thr);
    for (int i = threadIdx.x; i < k * C; i += n_thr) sdw[i] = 0.f;
    usk::named_bar_sync(1, n_thr);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int j = packed_tap(8 * n + 2 * tq + (e & 1), k, s);
                if (j >= 0) atomicAdd(&sdw[j * C + 64 * cb + 16 * mt + g + 8 * (e >> 1)],
                                      acc[mt][n][e]);
            }
    usk::fence_proxy_async();
    usk::named_bar_sync(1, n_thr);
    if (threadIdx.x == 0) {
        for (int j = 0; j < k; ++j) usk::bulk_reduce_add_f32(dw + j * C, sdw + j * C, C * 4);
        usk::bulk_commit();
        usk::bulk_wait();
    }
}

template <int kK, int kS, bool kRecompute>
cudaError_t launch_bwd(const void* wav, const void* w, const void* dy, const void* ds1,
                       const void* ds2, void* dw, int B, int ns, int t1, int C, int k, int stride,
                       cudaStream_t stream) {
    // 16 consumer warps (fewer if C / 64 does not divide 16): C / 64
    // channel blocks x rsplit 16-row chunks, a stage of R = 16 rsplit rows
    // (at most 32 KB of dy) and s R + 8 samples (+ 3 to align the first)
    const int nb = C / 64, rsplit = nb >= 16 ? 1 : kBwdMaxWarps / nb, R = 16 * rsplit;
    const int x_bytes = (stride * R + 11 + kXBox - 1) / kXBox * kXBox * 4;
    const int stage_bytes = (R * C * 2 + x_bytes + 1023) / 1024 * 1024;
    const int w_bytes = nb * 4 * 32 * 16;  // the weights' A fragments
    const int fit = (227 * 1024 - 1024 - 128 - w_bytes) / stage_bytes;
    const int n_stages = fit < kBwdStages ? fit : kBwdStages;
    const size_t smem = (size_t)n_stages * stage_bytes + 128 + w_bytes + 1024;
    CUtensorMap dy_map, x_map;
    const uint64_t dims[3] = {(uint64_t)C, (uint64_t)t1, (uint64_t)B};
    const uint64_t strides[2] = {(uint64_t)C * 2, (uint64_t)t1 * C * 2};
    const uint32_t box[3] = {64, (uint32_t)R, 1};
    const uint64_t x_dims[1] = {(uint64_t)B * ns};
    const uint32_t x_box[1] = {kXBox};
    if (!usk::make_tensor_map(&dy_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, dy, dims, strides,
                              box, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !usk::make_tensor_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, wav, x_dims, nullptr,
                              x_box, CU_TENSOR_MAP_SWIZZLE_NONE))
        return cudaErrorInvalidValue;
    auto kernel = l1_conv_bwd_kernel<kK, kS, kRecompute>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int tiles_per_b = (t1 + R - 1) / R, n_tiles = B * tiles_per_b;
    const int grid = n_tiles < usk::sm_count() ? n_tiles : usk::sm_count();
    kernel<<<grid, 32 * (nb * rsplit + 1), smem, stream>>>(
        dy_map, x_map, (const __nv_bfloat16*)w, (const float*)ds1, (const float*)ds2,
        (float*)dw, ns, t1, C, k, stride, rsplit, tiles_per_b, n_tiles, stage_bytes, n_stages);
    return cudaGetLastError();
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

// dy (B, t1, C) bf16 contiguous and 16-byte aligned, C % 64 == 0, C <= 1024;
// ds1 / ds2 (B, C) fp32 or null; dw (k, C) fp32 zeroed
extern "C" int usk_l1_conv_bwd(const void* wav, const void* w, const void* dy,
                               const void* ds1, const void* ds2, void* dw, int B, int ns,
                               int t1, int C, int k, int stride, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (k == 10 && stride == 5)  // every configuration in configs.py
        return (int)(ds2 ? launch_bwd<10, 5, true>(wav, w, dy, ds1, ds2, dw, B, ns, t1, C, k,
                                                    stride, st)
                         : launch_bwd<10, 5, false>(wav, w, dy, ds1, ds2, dw, B, ns, t1, C, k,
                                                     stride, st));
    return (int)(ds2 ? launch_bwd<0, 0, true>(wav, w, dy, ds1, ds2, dw, B, ns, t1, C, k, stride,
                                               st)
                     : launch_bwd<0, 0, false>(wav, w, dy, ds1, ds2, dw, B, ns, t1, C, k, stride,
                                                st));
}

extern "C" const char* usk_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
