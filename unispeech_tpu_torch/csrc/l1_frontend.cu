// First waveform conv layer + GroupNorm statistics, in one pass.
//
// Forward (l1_conv_fwd_kernel) replaces
// unispeech_tpu/ops/pallas/l1_frontend.py::_fwd_kernel (launched by
// _run_fwd): conv1d(1 -> C, k taps, stride s) of the bf16-rounded waveform,
// fp32 accumulation, bf16 output y1, plus (kStats; the TPU kernel's
// stats=True) the per-(batch, channel) fp32 sum and sum of squares of the
// bf16-rounded outputs; without them it writes y1 alone (the layer_norm
// extractor's call).
//
// Bound on the H100: bytes. At WavLM-Base+ width y1 is the largest tensor
// of the model (4 x 51,199 x 512 bf16 = 210 MB at 4 x 16 s, 63 us at 3.35
// TB/s) while the input is a 4 MB waveform, so the kernel is the y1 write
// (a pure write, which the card sustains at ~95% of its memory rate).
// Design: one persistent block per SM takes every grid-th (utterance,
// R-row tile) item, so the blocks write neighbouring tiles at a time. Its
// 16 warps never wait for each other: each computes its 16-row x 64-channel
// box in the JAX kernel's collapsed layout, y1^T = Wpack^T . X2cat^T, as
// K = 16 mma.sync.m16n8k16 products (the backward's recompute, the same
// helpers; the weights' A fragments in shared memory, the samples fetched
// two tiles ahead into registers), turns it into rows in a shared-memory
// slot (stmatrix.trans) and writes them with 16-byte streaming stores, four
// full 128-byte lines per instruction. The sums are tensor-core products as
// well: the packed bf16 y1 is the A fragment of Y1^T, so S1 += Y1^T . 1 and
// S2 += Y1^T . Y1 (its diagonal) accumulate exact products in fp32 over a
// warp's rows of one utterance, then one fp32 atomic per channel and sum at
// the warp's utterance crossings and end, so their summation order varies
// from run to run within fp32 rounding. (TMA stores of the same boxes, a
// block barrier per tile and CUDA-core sums were slower; PERF.md lists the
// variants timed.)
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

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// In the JAX kernel's collapsed layout, x2[t] = samples [s t, s t + 8),
// X2cat[t] = [x2[t], x2[t+1]] holds 16 packed taps and Wpack is the (16, C)
// packed kernel (zero at the packed taps that are not taps of the kernel),
// so y1 = X2cat . Wpack, or Y1^T = Wpack^T . X2cat^T as mma.sync.m16n8k16
// products of 16 channels x 8 rows.

// packed tap p (0..15) -> tap of the (k, C) kernel, or -1: p < 8 is lane p
// of collapsed row t (tap p, p < s), p >= 8 lane p - 8 of row t + 1 (tap
// s + p - 8, p - 8 < k - s)
__device__ __forceinline__ int packed_tap(int p, int k, int s) {
    return p < 8 ? (p < s ? p : -1) : (p - 8 < k - s ? s + p - 8 : -1);
}

// this lane's A fragment of Wpack^T (channels c0 .. c0 + 15 x the 16 packed
// taps)
__device__ __forceinline__ uint4 wpack_afrag(const __nv_bfloat16* __restrict__ w, int C, int k,
                                             int s, int c0, int lane) {
    const int g = lane >> 2, tq = lane & 3;
    uint32_t r4[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int c = c0 + g + 8 * (r & 1);
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int j = packed_tap(8 * (r >> 1) + 2 * tq + e, k, s);
            v[e] = j >= 0 ? usk::bf2f(w[j * C + c]) : 0.f;
        }
        r4[r] = pack_bf16x2(v[0], v[1]);
    }
    return make_uint4(r4[0], r4[1], r4[2], r4[3]);
}

// this lane's B fragments of X2cat^T for the collapsed rows r0 .. r0 + 15
// of the fp32 samples smp (row t from sample s t), rounded to bf16: xb[0] /
// xb[1] the packed taps 0-7 / 8-15 of rows r0 + g (x2[t] / x2[t + 1]),
// xb[2] / xb[3] those of rows r0 + 8 + g
__device__ __forceinline__ void x2cat_bfrags(uint32_t (&xb)[4], const float* smp, int s, int r0,
                                             int lane) {
    const int g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
        const float* p = smp + s * (r0 + (m & 1) + 8 * (m >> 1) + g) + 2 * tq;
        xb[m] = pack_bf16x2(p[0], p[1]);
    }
}

// y (16 channels x 16 rows, fp32) += Wpack^T . X2cat^T: y[n] holds rows
// r0 + 8 n .. r0 + 8 n + 7 in the m16n8k16 accumulator layout (lane: channels
// g and g + 8, rows 2 tq and 2 tq + 1)
__device__ __forceinline__ void y1t_mma(float (&y)[2][4], uint4 wv, const uint32_t (&xb)[4]) {
    const uint32_t wa[4] = {wv.x, wv.y, wv.z, wv.w};
    usk::mma_bf16_16816(y[0], wa, xb[0], xb[1]);
    usk::mma_bf16_16816(y[1], wa, xb[2], xb[3]);
}

// ---------------------------------------------------------------- forward

constexpr int kFwdWarps = 16;  // (64-channel block, 16-row chunk) each
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kFwdBox = 16 * 128;  // a 16-row x 64-channel bf16 box of y1
constexpr uint32_t kOnes = 0x3F803F80u;  // bf16 (1, 1)

// y1 (and with kStats its sums) of the (utterance, R-row tile) items
// blockIdx.x + i gridDim.x, R = 16 rsplit. Warp w owns the 16-row chunk
// w / wpr of every tile and the channel blocks w % wpr + q wpr, q < kCb (2
// above C = 1024, else 1). The warps never wait for each other: each
// fetches its x fragments' samples from global memory two tiles ahead into
// registers, turns its box of products into rows in a shared-memory slot of
// its own (stmatrix.trans, 128-byte swizzle) and stores them with 16-byte
// streaming stores, four full 128-byte lines per instruction. The sums are
// tensor-core products too: the packed bf16 y1 of a 16-channel m-tile is
// the A fragment of Y1^T, so S1 += Y1^T . 1 and S2 += Y1^T . Y1 (its
// diagonal) accumulate exact bf16 products in fp32 over the warp's rows.
template <int kK, int kS, bool kStats, int kCb>
__global__ void __launch_bounds__(kFwdThreads, 1) l1_conv_fwd_kernel(
    const float* __restrict__ wav,        // (B, ns) fp32
    const __nv_bfloat16* __restrict__ w,  // (k, C) bf16
    __nv_bfloat16* __restrict__ y,        // (B, t1, C) bf16
    float* __restrict__ s1,               // (B, C) fp32, zeroed (kStats)
    float* __restrict__ s2,               // (B, C) fp32, zeroed (kStats)
    int ns, int t1, int C, int k_rt, int s_rt, int wpr, int rsplit, int tiles_per_b,
    int n_tiles) {
    const int k = kK ? kK : k_rt, s = kS ? kS : s_rt;
    extern __shared__ unsigned char l1_smem_raw[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(l1_smem_raw) + 1023) & ~uintptr_t(1023));
    const int nb = C / 64, R = 16 * rsplit;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, tq = lane & 3;
    unsigned char* slot = smem + warp * kFwdBox;
    uint4* wfrag = reinterpret_cast<uint4*>(smem + kFwdWarps * kFwdBox);  // [nb][4][32]
    for (int i = tid; i < nb * 4 * 32; i += kFwdThreads)
        wfrag[i] = wpack_afrag(w, C, k, s, 16 * (i / 32), i % 32);
    __syncthreads();
    const int rc = warp / wpr;
    if (rc >= rsplit) return;

    // every grid-th item: the blocks write neighbouring tiles at a time
    const int first = blockIdx.x, last = n_tiles, step = gridDim.x;
    // this lane's samples of a tile's x fragments (x2cat_bfrags' order): rows
    // r0 + (m & 1) + 8 (m >> 1) + g, lanes 2 tq and 2 tq + 1; samples past
    // the utterance meet zero taps or rows >= t1
    auto fetch = [&](float (&v)[8], int tile) {
        const float* src = wav + (size_t)(tile / tiles_per_b) * ns;
        const int r0 = (tile % tiles_per_b) * R + 16 * rc;
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int i = s * (r0 + (m & 1) + 8 * (m >> 1) + g) + 2 * tq + e;
                v[2 * m + e] = i < ns ? __ldg(src + i) : 0.f;
            }
    };

    // per m-tile: S1 (16 channels x 8 equal columns) and S2 against the
    // channels 0-7 / 8-15 of the m-tile, whose diagonals are the sums
    float acc1[kCb][4][4], acc2[kCb][4][2][4];
    auto zero = [&]() {
#pragma unroll
        for (int q = 0; q < kCb; ++q)
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    acc1[q][mt][e] = acc2[q][mt][0][e] = acc2[q][mt][1][e] = 0.f;
    };
    // this warp's sums of utterance bb into s1 / s2: S1 from the lanes of
    // column 0, S2's diagonal from the lanes that hold it (tq = g / 2)
    auto flush = [&](int bb) {
#pragma unroll
        for (int q = 0; q < kCb; ++q) {
            const int cb = warp % wpr + q * wpr;
            if (cb >= nb) break;
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const size_t c = (size_t)bb * C + 64 * cb + 16 * mt + g + 8 * h;
                    const float* d2 = acc2[q][mt][h];  // a select, not an index: registers
                    if (tq == 0) atomicAdd(s1 + c, acc1[q][mt][2 * h]);
                    if (tq == g / 2) atomicAdd(s2 + c, (g & 1) ? d2[2 * h + 1] : d2[2 * h]);
                }
        }
        zero();
    };
    if (kStats) zero();

    float x0[8], x1[8], x2[8];  // the samples of tiles it, it + 1, it + 2
    if (first < last) fetch(x0, first);
    if (first + step < last) fetch(x1, first + step);
    // stmatrix: lanes 8i..8i+7 address the rows of matrix i = (rows 8 (i >> 1)
    // .., channels 8 (i & 1) .. of the m-tile)
    const int orow = 8 * (lane >> 4) + (lane & 7);
    int cur_b = first / tiles_per_b;
    for (int tile = first; tile < last; tile += step) {
        const int b = tile / tiles_per_b, r0 = (tile % tiles_per_b) * R + 16 * rc;
        if (kStats && b != cur_b) {
            flush(cur_b);
            cur_b = b;
        }
        if (tile + 2 * step < last) fetch(x2, tile + 2 * step);
        const int valid = t1 - r0;  // rows of this warp's chunk < t1
        if (valid > 0) {
            uint32_t xb[4];
#pragma unroll
            for (int m = 0; m < 4; ++m) xb[m] = pack_bf16x2(x0[2 * m], x0[2 * m + 1]);
#pragma unroll
            for (int q = 0; q < kCb; ++q) {
                const int cb = warp % wpr + q * wpr;
                if (cb >= nb) break;
#pragma unroll
                for (int mt = 0; mt < 4; ++mt) {
                    float yv[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
                    y1t_mma(yv, wfrag[(cb * 4 + mt) * 32 + lane], xb);
                    // matrix i: channels g + 8 (i & 1), rows 8 (i >> 1) + 2 tq + {0, 1};
                    // as a whole, the A fragment of Y1^T (16 channels x 16 rows)
                    uint32_t o[4];
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        o[i] = pack_bf16x2(yv[i >> 1][2 * (i & 1)], yv[i >> 1][2 * (i & 1) + 1]);
                    const int chunk = 2 * mt + ((lane >> 3) & 1);
                    usk::stmatrix_x4_trans(slot + orow * 128 + ((chunk ^ (orow & 7)) << 4), o);
                    if (kStats) {
                        if (valid < 16) {  // rows past t1 add nothing
#pragma unroll
                            for (int i = 0; i < 4; ++i) {
                                const int row = 8 * (i >> 1) + 2 * tq;
                                if (row >= valid) o[i] &= 0xFFFF0000u;
                                if (row + 1 >= valid) o[i] &= 0x0000FFFFu;
                            }
                        }
                        usk::mma_bf16_16816(acc1[q][mt], o, kOnes, kOnes);
                        usk::mma_bf16_16816(acc2[q][mt][0], o, o[0], o[2]);
                        usk::mma_bf16_16816(acc2[q][mt][1], o, o[1], o[3]);
                    }
                }
                __syncwarp();
                // 16 rows x 8 chunks of 16 bytes: lane l stores chunk l % 8 of rows
                // l / 8 + 4 j
                __nv_bfloat16* dst = y + ((size_t)b * t1 + r0) * C + 64 * cb + 8 * (lane & 7);
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int row = lane / 8 + 4 * j;
                    if (row < valid)
                        usk::st_stream(dst + (size_t)row * C,
                                       *reinterpret_cast<const uint4*>(
                                           slot + row * 128 + (((lane & 7) ^ (row & 7)) << 4)));
                }
                __syncwarp();
            }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            x0[i] = x1[i];
            x1[i] = x2[i];
        }
    }
    if (kStats && first < last) flush(cur_b);
}

template <int kK, int kS, bool kStats, int kCb>
cudaError_t launch_fwd(const void* wav, const void* w, void* y, void* s1, void* s2, int B,
                       int ns, int t1, int C, int k, int stride, cudaStream_t stream) {
    // 16 warps (fewer if C / 64 does not divide 16): min(C / 64, 16)
    // channel blocks x rsplit 16-row chunks, a tile of R = 16 rsplit rows
    const int nb = C / 64, wpr = nb < kFwdWarps ? nb : kFwdWarps, rsplit = kFwdWarps / wpr;
    if (nb > kCb * wpr) return cudaErrorInvalidValue;
    const int R = 16 * rsplit;
    const size_t smem = 1024 + (size_t)kFwdWarps * kFwdBox + nb * 4 * 32 * 16;
    auto kernel = l1_conv_fwd_kernel<kK, kS, kStats, kCb>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int tiles_per_b = (t1 + R - 1) / R, n_tiles = B * tiles_per_b;
    const int grid = n_tiles < usk::sm_count() ? n_tiles : usk::sm_count();
    kernel<<<grid, kFwdThreads, smem, stream>>>((const float*)wav, (const __nv_bfloat16*)w,
                                                (__nv_bfloat16*)y, (float*)s1, (float*)s2, ns,
                                                t1, C, k, stride, wpr, rsplit, tiles_per_b,
                                                n_tiles);
    return cudaGetLastError();
}

template <int kK, int kS>
cudaError_t launch_fwd_geometry(const void* wav, const void* w, void* y, void* s1, void* s2,
                                int B, int ns, int t1, int C, int k, int stride,
                                cudaStream_t st) {
    const bool wide = C > 64 * kFwdWarps, stats = s1 != nullptr;
    if (stats)
        return wide ? launch_fwd<kK, kS, true, 2>(wav, w, y, s1, s2, B, ns, t1, C, k, stride, st)
                    : launch_fwd<kK, kS, true, 1>(wav, w, y, s1, s2, B, ns, t1, C, k, stride, st);
    return wide ? launch_fwd<kK, kS, false, 2>(wav, w, y, s1, s2, B, ns, t1, C, k, stride, st)
                : launch_fwd<kK, kS, false, 1>(wav, w, y, s1, s2, B, ns, t1, C, k, stride, st);
}

// ---------------------------------------------------------------- backward

constexpr int kBwdMaxWarps = 16;  // consumer warps: (64-channel block, 16-row chunk) each
constexpr int kBwdThreads = 32 * (kBwdMaxWarps + 1);  // and one producer warp
constexpr int kBwdStages = 6;  // ring stages, fewer where six do not fit
constexpr int kXBox = 128;  // fp32 samples per TMA box of the waveform

// dW[j, c] = sum over (b, t < t1) of x[b, t*s + j] * dy1[b, t, c],
// dy1 = bf16(dy + ds1 + 2 ds2 y1). Per block: a persistent walk over the
// (utterance, R-row tile) items, R = 16 rsplit. One producer thread keeps a
// ring of up to kBwdStages stages full by TMA: dy as C / 64 boxes of R rows
// x 64 channels (128-byte swizzle; rows past t1 zero-filled) and the tile's
// s R + 8 fp32 samples from sample s t0 (read from the 16-byte boundary
// before it, as boxes of a 1-D map over the flattened waveform). Each
// consumer warp owns one 64-channel block and one 16-row chunk of every
// tile. Y1^T = Wpack^T . X2cat^T (as the forward) and dWpack^T += dY1^T .
// X2cat are mma.sync.m16n8k16 products, and the y1 accumulator is, after
// the elementwise dy1, the A fragment of the second product. The x fragments
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
        for (int mt = 0; mt < 4; ++mt)
            wfrag[(cb * 4 + mt) * 32 + lane] = wpack_afrag(w, C, k, s, 64 * cb + 16 * mt, lane);
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
            if (kRecompute) x2cat_bfrags(xb, smp, s, 16 * rc, lane);
#pragma unroll
            for (int m = 0; m < 4; ++m) {
                const float* q = smp + s * (16 * rc + (m & 1) + 8 * (m >> 1) + 2 * tq) + g;
                xt[m] = pack_bf16x2(q[0], q[s]);
            }
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
                uint32_t d[4];
                const int chunk = 2 * mt + ((lane >> 3) & 1);
                usk::ldmatrix_x4_trans(d, sdy + drow * 128 + ((chunk ^ (drow & 7)) << 4));
                float y[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
                if (kRecompute) y1t_mma(y, wfrag[(cb * 4 + mt) * 32 + lane], xb);
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

// y (B, t1, C) bf16 contiguous and 16-byte aligned, C % 64 == 0, C <= 2048;
// s1 / s2 (B, C) fp32 zeroed, or both null (no sums)
extern "C" int usk_l1_conv_fwd(const void* wav, const void* w, void* y, void* s1, void* s2,
                               int B, int ns, int t1, int C, int k, int stride, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (k == 10 && stride == 5)  // every configuration in configs.py
        return (int)launch_fwd_geometry<10, 5>(wav, w, y, s1, s2, B, ns, t1, C, k, stride, st);
    return (int)launch_fwd_geometry<0, 0>(wav, w, y, s1, s2, B, ns, t1, C, k, stride, st);
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
