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
// sums' cotangents, the layer_norm extractor's call, dy1 = dy).
// Bound on the H100: bytes, the read of dy (6 x 49,167 x 512 fp32 = 604 MB
// at the WavLM-Base pretraining batch, 0.18 ms at 3.35 TB/s). The products
// are ~23 fp32 operations per dy element with the recompute (k FMAs for y1,
// 3 for dy1, k for dW), ~0.11 ms of the CUDA cores' issue at k = 10 at
// their full rate: under the bytes, so they stay exact fp32 on the CUDA
// cores and the design is about keeping the read going under them (on the
// same card the consumers alone, without the copies, ran ~0.19 ms and the
// copies alone ~0.20: PERF.md §6).
// What held the first form back (0.43 ms, 42% of the bound on an NVIDIA
// H100 80GB HBM3 at 700 W): blocks of one run of rows each, whose threads
// loaded one 16-byte piece of dy per row and used it at once (~8 KB in
// flight per SM, where the memory's latency wants ~20 KB), a tail wave of
// blocks, and two block barriers per 64-row window of staged samples.
// Design: one persistent block per SM (the plan, l1_frontend.bwd_f32_plan,
// comes from the host: tile rows R, ring stages, grid, shared memory) walks
// the (utterance, R-row tile) items blockIdx.x + i gridDim.x, so no tile
// crosses an utterance and there is no tail wave. A producer thread keeps
// a ring of four 31-35 KB stages full, up to 96 KB in flight per SM (six
// stages read no faster): dy's rows t0 .. t0 + R - 1 of one utterance are
// one contiguous range, so one 1-D bulk copy moves them (no tensor map and
// no swizzle: the consumers read whole rows, neighbouring threads
// neighbouring 16 bytes; a tile cut by t1 copies its rows < t1 alone), and
// the tile's s R + k - s samples come as 1-D TMA boxes of a tensor map over
// the flattened waveform, from the 16-byte boundary at or before b ns + t0 s
// (a box must start on one; past the end they read as zero). Eight
// consumer warps: thread (cx, ry) owns channels 4 cx .. 4 cx + 3 and the 8
// consecutive rows 8 ry .. of every tile (R = 8 x 1024 / C), reads dy from
// the stage as float4, holds the k taps of its channels (with the
// recompute) and, with (k, s) known at compile time, its 8 rows' 7 s + k
// samples in registers (s new samples per row, not k; the generic instance
// reads them from the stage per tap), and keeps its k x 4 dW partial sums
// in registers over the whole walk. At the end the block adds them across
// its warps in shared memory (the ring is free by then) and into the zeroed
// fp32 dW by k bulk reductions, once per block, so dW's summation order
// varies from run to run within fp32 rounding. The ring is addressed from
// the shared array itself: through an integer the compiler lost its
// address space and made every ring access a generic load (7% slower on
// that card).

#include "common.cuh"
#include "hopper.cuh"

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

constexpr int kBwdWarps = 8;                       // consumer warps
constexpr int kBwdThreads = 32 * (kBwdWarps + 1);  // and one producer warp
constexpr int kBwdRows = 8;                        // consecutive rows of a thread per tile
constexpr int kXBox = 128;                         // fp32 samples per TMA box of the waveform
constexpr int kSmemMax = 232448;                   // dynamic shared memory a block may take

// a thread's rows of one tile: dy1 of its 4 channels and their dW partials
// (kFull: all kBwdRows rows are < t1, else the first nr)
template <int kK, int kS, bool kRecompute, bool kFull, int kTaps>
__device__ __forceinline__ void bwd_f32_rows(float4 (&acc)[kTaps],
                                             const float4 (&wr)[kRecompute ? kTaps : 1], float4 d1,
                                             float4 d2, const float* sdy, const float* smp, int C,
                                             int k, int s, int nr) {
    // the rows' samples: with (k, s) known, all in registers (row i's taps
    // at xs[i s ..], s new ones per row); else read from the stage per tap
    constexpr int kSamples = kK ? (kBwdRows - 1) * kS + kK : 1;
    float xs[kSamples];
    if constexpr (kK != 0) {
#pragma unroll
        for (int i = 0; i < kSamples; ++i) xs[i] = smp[i];
    }
    auto x = [&](int i, int j) {  // tap j of row i
        if constexpr (kK != 0) return xs[i * kS + j];
        else return smp[i * s + j];
    };
#pragma unroll
    for (int i = 0; i < kBwdRows; ++i) {
        if (!kFull && i >= nr) break;
        float4 d = *reinterpret_cast<const float4*>(sdy + (size_t)i * C);
        d = make_float4(__fadd_rn(d.x, d1.x), __fadd_rn(d.y, d1.y), __fadd_rn(d.z, d1.z),
                        __fadd_rn(d.w, d1.w));
        if constexpr (kRecompute) {
            float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int j = 0; j < kTaps; ++j) {
                if (!kK && j >= k) break;
                const float xv = x(i, j);
                y.x = fmaf(xv, wr[j].x, y.x);
                y.y = fmaf(xv, wr[j].y, y.y);
                y.z = fmaf(xv, wr[j].z, y.z);
                y.w = fmaf(xv, wr[j].w, y.w);
            }
            d = make_float4(__fadd_rn(d.x, __fmul_rn(d2.x, y.x)),
                            __fadd_rn(d.y, __fmul_rn(d2.y, y.y)),
                            __fadd_rn(d.z, __fmul_rn(d2.z, y.z)),
                            __fadd_rn(d.w, __fmul_rn(d2.w, y.w)));
        }
#pragma unroll
        for (int j = 0; j < kTaps; ++j) {
            if (!kK && j >= k) break;
            const float xv = x(i, j);
            acc[j].x = fmaf(xv, d.x, acc[j].x);
            acc[j].y = fmaf(xv, d.y, acc[j].y);
            acc[j].z = fmaf(xv, d.z, acc[j].z);
            acc[j].w = fmaf(xv, d.w, acc[j].w);
        }
    }
}

// dW of the (utterance, R-row tile) items blockIdx.x + i gridDim.x, R =
// rows. The ring's stage: R C fp32 of dy, then x_boxes kXBox-sample boxes
// of the waveform from sample (b ns + t0 s) & ~3; barriers after the ring.
template <int kK, int kS, bool kRecompute>
__global__ void __launch_bounds__(kBwdThreads, 1) l1_conv_bwd_f32_kernel(
    const __grid_constant__ CUtensorMap x_map,  // (B ns) fp32, boxes of kXBox
    const float* __restrict__ w,    // (k, C), read with kRecompute
    const float* __restrict__ dy,   // (B, t1, C)
    const float* __restrict__ ds1,  // (B, C) or null
    const float* __restrict__ ds2,  // (B, C), null iff !kRecompute
    float* __restrict__ dw,         // (k, C), zeroed
    int B, int ns, int t1, int C, int k_rt, int s_rt, int rows, int x_boxes, int stage_bytes,
    int n_stages) {
    constexpr int kTaps = kK ? kK : kMaxTaps;
    const int k = kK ? kK : k_rt, s = kS ? kS : s_rt;
    // the ring from the first 1024-byte boundary: offset from the shared
    // array itself (not through an integer), so the compiler keeps every
    // access of it in the shared space (LDS, shared atomics)
    extern __shared__ unsigned char l1f_smem_raw[];
    unsigned char* smem = l1f_smem_raw + ((1024 - (usk::smem_u32(l1f_smem_raw) & 1023)) & 1023);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)n_stages * stage_bytes);
    uint64_t* empty = full + n_stages;
    const int R = rows, dy_bytes = R * C * 4;
    const int tiles_per_b = (t1 + R - 1) / R, n_tiles = B * tiles_per_b;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (threadIdx.x == 0) {
        for (int st = 0; st < n_stages; ++st) {
            usk::mbar_init(&full[st], 1);
            usk::mbar_init(&empty[st], kBwdWarps);
        }
        usk::fence_barrier_init();
    }
    __syncthreads();

    if (warp == kBwdWarps) {  // producer
        if (lane == 0) {
            int it = 0;
            for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
                const int st = it % n_stages;
                const int b = tile / tiles_per_b, t0 = (tile % tiles_per_b) * R;
                const int nr = min(R, t1 - t0);
                unsigned char* stage = smem + (size_t)st * stage_bytes;
                usk::mbar_wait(&empty[st], ((it / n_stages) & 1) ^ 1);
                usk::mbar_expect_tx(&full[st], nr * C * 4 + x_boxes * kXBox * 4);
                usk::bulk_load(stage, dy + ((size_t)b * t1 + t0) * C, nr * C * 4, &full[st]);
                const int x0 = (b * ns + t0 * s) & ~3;
                for (int xb = 0; xb < x_boxes; ++xb)
                    usk::tma_load_1d(stage + dy_bytes + xb * kXBox * 4, &x_map, &full[st],
                                     x0 + xb * kXBox);
            }
        }
        return;
    }

    const int nx = C / 4, ny = R / kBwdRows;
    const int cx = threadIdx.x % nx, ry = threadIdx.x / nx, r0 = kBwdRows * ry;
    const bool active = ry < ny;  // C / 4 need not divide the 256 threads
    float4 wr[kRecompute ? kTaps : 1];
    float4 acc[kTaps];
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
        acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        if constexpr (kRecompute)
            wr[j] = active && (kK || j < k)
                        ? *reinterpret_cast<const float4*>(w + (size_t)j * C + 4 * cx)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float4 d1 = make_float4(0.f, 0.f, 0.f, 0.f), d2 = d1;  // ds1 and 2 ds2 (zero: no such term)
    int it = 0, cur_b = -1;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
        const int st = it % n_stages;
        const int b = tile / tiles_per_b, t0 = (tile % tiles_per_b) * R;
        if (b != cur_b && active) {
            cur_b = b;
            if (ds1 != nullptr)
                d1 = *reinterpret_cast<const float4*>(ds1 + (size_t)b * C + 4 * cx);
            if constexpr (kRecompute) {
                d2 = *reinterpret_cast<const float4*>(ds2 + (size_t)b * C + 4 * cx);
                d2 = make_float4(2.f * d2.x, 2.f * d2.y, 2.f * d2.z, 2.f * d2.w);
            }
        }
        usk::mbar_wait(&full[st], (it / n_stages) & 1);
        const int nr = t1 - t0 - r0;  // rows of this thread's chunk < t1
        if (active && nr > 0) {
            const unsigned char* stage = smem + (size_t)st * stage_bytes;
            const float* sdy = reinterpret_cast<const float*>(stage) + (size_t)r0 * C + 4 * cx;
            const float* smp = reinterpret_cast<const float*>(stage + dy_bytes) +
                               ((b * ns + t0 * s) & 3) + r0 * s;
            if (nr >= kBwdRows)
                bwd_f32_rows<kK, kS, kRecompute, true>(acc, wr, d1, d2, sdy, smp, C, k, s, nr);
            else
                bwd_f32_rows<kK, kS, kRecompute, false>(acc, wr, d1, d2, sdy, smp, C, k, s, nr);
        }
        __syncwarp();
        if (lane == 0) usk::mbar_arrive(&empty[st]);
    }

    // the ring is free once every consumer is past its last stage: sum the
    // threads' (tap, channel) partials there, then add them into dW
    constexpr int kConsumers = 32 * kBwdWarps;
    float* sdw = reinterpret_cast<float*>(smem);  // (k, C)
    usk::named_bar_sync(1, kConsumers);
    for (int i = threadIdx.x; i < k * C; i += kConsumers) sdw[i] = 0.f;
    usk::named_bar_sync(1, kConsumers);
    if (active) {
#pragma unroll
        for (int j = 0; j < kTaps; ++j) {
            if (!kK && j >= k) break;
            float* dst = sdw + j * C + 4 * cx;
            atomicAdd(dst, acc[j].x);
            atomicAdd(dst + 1, acc[j].y);
            atomicAdd(dst + 2, acc[j].z);
            atomicAdd(dst + 3, acc[j].w);
        }
    }
    usk::fence_proxy_async();
    usk::named_bar_sync(1, kConsumers);
    if (threadIdx.x == 0) {
        for (int j = 0; j < k; ++j) usk::bulk_reduce_add_f32(dw + j * C, sdw + j * C, C * 4);
        usk::bulk_commit();
        usk::bulk_wait();
    }
}

template <int kK, int kS>
cudaError_t launch_bwd_f32(const void* wav, const void* w, const void* dy, const void* ds1,
                           const void* ds2, void* dw, int B, int ns, int t1, int C, int k,
                           int stride, int rows, int n_stages, int grid, int smem,
                           cudaStream_t st) {
    if (C % 64 != 0 || C > 1024 || k > kMaxTaps || stride > 8) return cudaErrorInvalidValue;
    // a stage as l1_frontend.bwd_f32_plan sizes it (1024-byte aligned): R C
    // fp32 of dy, then boxes of the s R + k - s samples (+ 3 before them);
    // the plan must give whole threads' rows within the consumers and a
    // ring that holds the final reduction and fits with its barriers
    const int x_boxes = (stride * rows + k - stride + 3 + kXBox - 1) / kXBox;
    const int stage_bytes = (rows * C * 4 + x_boxes * kXBox * 4 + 1023) / 1024 * 1024;
    if (rows <= 0 || rows % kBwdRows != 0 || rows / kBwdRows * (C / 4) > 32 * kBwdWarps ||
        n_stages < 1 || grid < 1 || k * C * 4 > n_stages * stage_bytes ||
        smem < n_stages * stage_bytes + 16 * n_stages + 1024 || smem > kSmemMax)
        return cudaErrorInvalidValue;
    CUtensorMap x_map;
    const uint64_t x_dims[1] = {(uint64_t)B * ns};
    const uint32_t x_box[1] = {kXBox};
    if (!usk::make_tensor_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, wav, x_dims, nullptr,
                              x_box, CU_TENSOR_MAP_SWIZZLE_NONE))
        return cudaErrorInvalidValue;
    auto kernel = ds2 != nullptr ? l1_conv_bwd_f32_kernel<kK, kS, true>
                                 : l1_conv_bwd_f32_kernel<kK, kS, false>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kBwdThreads, smem, st>>>(x_map, (const float*)w, (const float*)dy,
                                            (const float*)ds1, (const float*)ds2, (float*)dw, B,
                                            ns, t1, C, k, stride, rows, x_boxes, stage_bytes,
                                            n_stages);
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

// wav (B, ns) fp32 contiguous, 16-byte aligned; w (k, C) fp32 contiguous,
// 16-byte aligned (read only with ds2); dy (B, t1, C) fp32 contiguous,
// 16-byte aligned; ds1 / ds2 (B, C) fp32 contiguous, 16-byte aligned, or
// null; dw (k, C) fp32 zeroed; C % 64 == 0, C <= 1024, stride <= k <= 2
// stride <= 16; rows, stages, grid, smem: l1_frontend.bwd_f32_plan
extern "C" int usk_l1_conv_bwd_f32(const void* wav, const void* w, const void* dy,
                                   const void* ds1, const void* ds2, void* dw, int B, int ns,
                                   int t1, int C, int k, int stride, int rows, int stages,
                                   int grid, int smem, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (k == 10 && stride == 5)  // every configuration in configs.py
        return (int)launch_bwd_f32<10, 5>(wav, w, dy, ds1, ds2, dw, B, ns, t1, C, k, stride, rows,
                                          stages, grid, smem, st);
    return (int)launch_bwd_f32<0, 0>(wav, w, dy, ds1, ds2, dw, B, ns, t1, C, k, stride, rows,
                                     stages, grid, smem, st);
}
