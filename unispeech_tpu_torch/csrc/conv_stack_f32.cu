// Fused strided-conv1d + GELU block of the waveform frontend, forward and
// backward, in fp32 (the models' default dtype).
//
// Forward: replaces unispeech_tpu/ops/pallas/conv_stack.py::_fwd_kernel
// (launched by _run_fwd) at fp32:
//   H = gelu_in?(x * a[b] + b[b])          (the H pass; only with either)
//   pre[b, t] = sum_{p < k} H[b, 2t + p] . W[p]   (k in {2, 3}, stride 2)
//   y = gelu_out?(pre)
// with exact erf GELU, all in fp32, and pre written too when asked (the
// autograd forward saves it).
// Backward: replaces ::_bwd_kernel (launched by _run_bwd) at fp32. With
// g = gelu'(pre) * dy (g = dy without the output GELU), x^ = x * a + b (or
// x) and H = gelu_in?(x^):
//   dX^[2t + p] = sum over taps p of g[t] . W_p^T;  dX^ *= gelu'(x^) if gelu_in;
//   da = sum_t dX^ * x, db = sum_t dX^;  dx = dX^ * a (or dX^), zero from valid on
//   dW_p = sum_{b, t < t_out} H[b, 2t + p]^T . g[b, t]
// in fp32, gelu' the exact erf derivative.
//
// Bound on the H100: operations. One TF32 product keeps 11 bits of each
// operand, which is not fp32, so every product here is the 3xTF32 split
// (tf32.cuh): three tensor-core products per fragment. At WavLM-Base+ width
// (C = 512) the six blocks of a 4 x 16 s forward are 311.5 GFLOP: 1.89 ms
// as 3xTF32 at the TF32 peak of 495 TFLOP/s, against 1.26 GB moved (0.38
// ms). At the WavLM-Base pretraining batch (6 x 245,840 samples) dx and dW
// of the six blocks are 899 GFLOP: 5.45 ms as 3xTF32, against ~3.5 GB
// moved (1.0 ms).
//
// Launches, as the bf16 kernels' (one launch count serves both dtypes):
// forward conv_h_f32_kernel (H; only with the affine or gelu_in), then
// conv_gemm_f32_kernel; backward conv_bwd_g_f32_kernel (g; only with the
// output GELU), conv_h_f32_kernel, conv_bwd_dx_f32_kernel and
// conv_bwd_dw_f32_kernel.
//
// The three GEMMs (the Hopper redesign of a first form on mma.sync.m16n8k8,
// which split every fragment in every warp at every use, added dW by one
// fp32 atomic per element and held 93-123 TFLOP/s of TF32):
//  - wgmma in TF32 (m64n128k8): a block is two warpgroups of 64 rows over a
//    128 x 128 tile, the fp32 sums in registers. TF32 wgmma reads a
//    shared-memory operand only K-major (hopper.cuh), and may take A from
//    registers in the m16n8k8 fragment layout. So A always comes from
//    registers: each warp reads its fragments of the raw fp32 A tile and
//    splits them there (an A element is split once per block, by the one
//    thread that multiplies it). That also lets dW read H in the
//    [row][channel] layout it has, which is MN-major for that product. B
//    is split once per block, by the block's threads, into a hi and a lo
//    tile, K-major in the 128-byte swizzle (rows of 32 floats), which both
//    warpgroups read;
//  - the A tiles arrive by TMA into a ring of 4 stages (3 beside dx's x
//    tile) on mbarriers, K in steps of 32 (one swizzled fp32 row). While
//    stage j's products run, every thread waits until the slot of stage j
//    + 3 is free, splits and stores its share of that stage's B (in its
//    registers since the stage before), arrives on the slot's barrier and
//    loads its share of stage j + 4's B: the loads from L2 have a whole
//    stage to land;
//  - three products per k8 step (a_lo.B_hi, a_hi.B_lo, a_hi.B_hi; lo.lo,
//    ~2^-22 relative, dropped) go into a fresh 64 x 128 accumulator per
//    32-deep stage, which fp32 adds put into the running sum: the tensor
//    cores' fp32 accumulation truncates, and a running sum kept in them
//    over K = 1536 missed the 1e-5 relative gate (tf32.cuh). Running and
//    fresh sums are 128 registers a thread, so a warpgroup holds 64 x 128;
//  - what bounds it (PERF.md, scripts/exp_conv_f32_variants.py): the
//    operands' traffic and the per-stage work around the products, not the
//    tensor cores (these products alone run at ~488 TFLOP/s of TF32 on the
//    H100): B, reloaded from L2 by every 128-row block, 16 KB a stage,
//    costs 10-25% of the time. B by TMA into a staging tile split from
//    shared memory, one warpgroup per block at two blocks per SM, and B
//    shared by TMA multicast across clusters of four blocks all ran slower;
//  - forward: A is the stride-2 windows of H in place, through two tensor
//    maps that view H (B, rows, C) as its even and odd rows (row stride
//    2C): tap 0 of output row t is even row t, tap 1 odd row t, tap 2 even
//    row t + 1, each a 128-row box inside one utterance (rows past the
//    input load as zeros; nothing is stored past t_out). B is the weight as
//    (C_out, k C_in), K-major, as the wrapper passes it. The epilogue
//    applies the output GELU and stores y (and pre) by 8-byte stores;
//  - dx: a block does 128 rows t' of both input-row parities (r = 2t' +
//    par), parity 0 over taps 0 (g row t') and 2 (g row t' - 1), parity 1
//    over tap 1, one epilogue each. A = g rows through a (C, t_out, B) map
//    (TMA zero-fills row -1 and the rows past t_out), B = W_p as stored
//    ([tap][in][out], K-major in the output channel). In the first block
//    the epilogue reads x from a tile that TMA loads (through x's even/odd
//    views) while the parity's products run, and the affine's columns from
//    shared memory; it applies gelu'(x^) (x^ recomputed: mul then add, each
//    rounded, as the H pass), reduces da/db over a warp's 16 rows by a
//    reduce-scatter (7 shuffles per two 8-column slices) and one global
//    fp32 add per lane, scales by a and stores dx, zero on the rows from
//    valid to the input's end;
//  - dW: split-K over the (utterance, 32-row step) pieces of the B t_out
//    rows (no box spans two utterances), the splits sized by the wrapper
//    (conv_stack.dw_split_plan) to fill whole waves of the card. A = H rows
//    2t + p through the even/odd views (their rows cut at the last one a
//    tap reaches; four 32-channel boxes, read as the transposed fragment),
//    B = g^T, which the loaders transpose as they split it (g rows past
//    t_out stored as zeros). Each block adds its fp32 tile into dW through
//    the ring's shared memory by TMA tensor reductions of 64 x 32 boxes.
// The fp32 sums of dW over splits and of da/db over row tiles vary in order
// from run to run within fp32 rounding.

#include "common.cuh"
#include "hopper.cuh"
#include "tf32.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 32;  // tile rows and columns, K per stage
constexpr int kThreads = 256;                  // two warpgroups of 64 rows
constexpr int kStages = 4;                     // the ring's slots (3 beside dx's x tile)
constexpr uint32_t kTile = kBM * kBK * 4;      // an A, B hi or B lo tile: 16 KB
constexpr uint32_t kStageBytes = 3 * kTile;
constexpr int kVec = 4;

// the shared memory of a ring of kS slots, and extra bytes behind its barriers
constexpr size_t ring_bytes(int kS, uint32_t extra = 0) {
    return 1024 + (size_t)kS * kStageBytes + 2 * kS * 8 + extra;
}

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

// ------------------------------------------------------------ the GEMM core

// the ring: kS slots of (A, B hi, B lo) from a 1024-byte aligned base,
// then the barriers. full[s]: the slot's A landed (one expect_tx arrival)
// and every thread stored its share of B; empty[s]: every warp's products
// on the slot are done
template <int kS>
struct Ring {
    unsigned char* smem;
    uint64_t* full;
    uint64_t* empty;
    __device__ unsigned char* slot(int s) const { return smem + s * kStageBytes; }
    __device__ unsigned char* extra() const {  // behind the barriers
        return reinterpret_cast<unsigned char*>(empty + kS);
    }
};

template <int kS>
__device__ __forceinline__ Ring<kS> ring_setup(unsigned char* raw) {
    Ring<kS> r;
    r.smem = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                              ~uintptr_t(1023));
    r.full = reinterpret_cast<uint64_t*>(r.smem + kS * kStageBytes);
    r.empty = r.full + kS;
    if (threadIdx.x == 0) {
        for (int s = 0; s < kS; ++s) {
            usk::mbar_init(&r.full[s], kThreads + 1);
            usk::mbar_init(&r.empty[s], kThreads / 32);
        }
        usk::fence_barrier_init();
    }
    __syncthreads();
    return r;
}

// x split into the hi and lo tiles at byte offset off
__device__ __forceinline__ void store_split(unsigned char* hi, unsigned char* lo, uint32_t off,
                                            float4 x) {
    const float2 p0 = usk::split_pair(x.x), p1 = usk::split_pair(x.y);
    const float2 p2 = usk::split_pair(x.z), p3 = usk::split_pair(x.w);
    *reinterpret_cast<float4*>(hi + off) = make_float4(p0.x, p1.x, p2.x, p3.x);
    *reinterpret_cast<float4*>(lo + off) = make_float4(p0.y, p1.y, p2.y, p3.y);
}

// B rows n0 + r of a row-major matrix (row stride ld floats), K columns k0
// .. k0 + 31, for a K-major tile: unit u = tid + 256 i is row u / 8, chunk
// u % 8 (8 threads read a row's 128 bytes)
__device__ __forceinline__ void load_rows(const float* src, size_t ld, int k0, int tid,
                                          float4 (&v)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int u = tid + kThreads * i;
        v[i] = __ldg(reinterpret_cast<const float4*>(src + (size_t)(u >> 3) * ld + k0 + 4 * (u & 7)));
    }
}

__device__ __forceinline__ void store_rows(int tid, const float4 (&v)[4], unsigned char* hi,
                                           unsigned char* lo) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int u = tid + kThreads * i;
        store_split(hi, lo, usk::sw_tf32(u >> 3, 4 * (u & 7), kBN), v[i]);
    }
}

// stage j into its slot once it is free: A by TMA, and B from this
// thread's share in registers (v, loaded a stage earlier), split
template <int kS, class Op>
__device__ __forceinline__ void produce(const Op& op, const Ring<kS>& ring, int j, int tid,
                                        const float4 (&v)[4]) {
    const int s = j % kS;
    if (j >= kS) usk::mbar_wait(&ring.empty[s], ((j / kS) & 1) ^ 1);
    unsigned char* slot = ring.slot(s);
    if (tid == 0) {
        usk::mbar_expect_tx(&ring.full[s], kTile);
        op.load_a(j, slot, &ring.full[s]);
    }
    op.store_b(tid, v, slot + kTile, slot + 2 * kTile);
    usk::fence_proxy_async();  // the stores, visible to wgmma
    usk::mbar_arrive(&ring.full[s]);
}

// the nk stages of a block's GEMM: this warpgroup's 64 x 128 of the tile,
// handed to op.epilogue at the stages where op.segment_end says a sum ends
template <int kS, class Op>
__device__ __forceinline__ void gemm(const Op& op, const Ring<kS>& ring, int nk) {
    const int tid = threadIdx.x, wg = tid / 128, wq = (tid / 32) % 4, lane = tid % 32;
    const int r0 = 64 * wg + 16 * wq + (lane >> 2), c0 = lane & 3;
    // B of stage j + 1 is in flight to registers while stage j's products run
    float4 v[4];
    for (int j = 0; j < kS - 1 && j < nk; ++j) {
        op.load_b(j, tid, v);
        produce(op, ring, j, tid, v);
    }
    if (kS - 1 < nk) op.load_b(kS - 1, tid, v);
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int ks = 0; ks < nk; ++ks) {
        const int s = ks % kS;
        usk::mbar_wait(&ring.full[s], (ks / kS) & 1);
        const unsigned char* slot = ring.slot(s);
        // A fragments (rows r0, r0 + 8; columns 8 kk + c0, + 4), split here
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const int c = 8 * kk + c0;
            usk::split_tf32(*reinterpret_cast<const float*>(slot + op.a_off(r0, c)), ah[kk][0], al[kk][0]);
            usk::split_tf32(*reinterpret_cast<const float*>(slot + op.a_off(r0 + 8, c)), ah[kk][1], al[kk][1]);
            usk::split_tf32(*reinterpret_cast<const float*>(slot + op.a_off(r0, c + 4)), ah[kk][2], al[kk][2]);
            usk::split_tf32(*reinterpret_cast<const float*>(slot + op.a_off(r0 + 8, c + 4)), ah[kk][3], al[kk][3]);
        }
        float t[64];  // the stage's fresh sum
        usk::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const uint64_t dh = usk::desc_sw128(slot + kTile + 32 * kk, 16, 1024);
            const uint64_t dl = usk::desc_sw128(slot + 2 * kTile + 32 * kk, 16, 1024);
            usk::wgmma_m64n128k8_rs_tf32(t, al[kk], dh, kk > 0);
            usk::wgmma_m64n128k8_rs_tf32(t, ah[kk], dl, 1);
            usk::wgmma_m64n128k8_rs_tf32(t, ah[kk], dh, 1);
        }
        usk::wgmma_commit();
        if (ks + kS - 1 < nk) {
            produce(op, ring, ks + kS - 1, tid, v);
            if (ks + kS < nk) op.load_b(ks + kS, tid, v);
        }
        usk::wgmma_wait<0>();
        usk::fence_regs(t);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            usk::fence_regs(ah[kk]);
            usk::fence_regs(al[kk]);
        }
        __syncwarp();
        if (lane == 0) usk::mbar_arrive(&ring.empty[s]);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += t[i];
        if (op.segment_end(ks, nk)) {
            op.epilogue(acc, ks, ring);
#pragma unroll
            for (int i = 0; i < 64; ++i) acc[i] = 0.f;
        }
    }
}

// accumulator element 4 n + e of a thread: row 16 wq + lane / 4 + 8 (e >> 1)
// of its warpgroup's 64, column 8 n + 2 (lane % 4) + (e & 1)

// ------------------------------------------------------------------ forward

struct FwdMaps {
    CUtensorMap even;  // the source's rows 2r:   dims {C, ceil(rows/2), B}, boxes of 32 x 128
    CUtensorMap odd;   // its rows 2r + 1:       dims {C, floor(rows/2), B}
};

template <bool kGelu, bool kPre>
struct FwdOp {
    const FwdMaps* maps;
    const float* wt;  // (C_out, k C_in)
    float* y;
    float* pre;
    int t_out, C, kC, m0, n0, b;

    __device__ void load_a(int j, unsigned char* dst, uint64_t* bar) const {
        const int kk = j * kBK, tap = kk / C, c0 = kk - tap * C;
        // tap 0: even row t, tap 1: odd row t, tap 2: even row t + 1
        usk::tma_load_3d(dst, tap == 1 ? &maps->odd : &maps->even, bar, c0, m0 + (tap >> 1), b);
    }
    __device__ void load_b(int j, int tid, float4 (&v)[4]) const {
        load_rows(wt + (size_t)n0 * kC, kC, j * kBK, tid, v);
    }
    __device__ void store_b(int tid, const float4 (&v)[4], unsigned char* hi,
                            unsigned char* lo) const {
        store_rows(tid, v, hi, lo);
    }
    __device__ uint32_t a_off(int r, int c) const { return usk::sw_tf32(r, c, kBM); }
    __device__ bool segment_end(int ks, int nk) const { return ks == nk - 1; }
    __device__ void epilogue(const float (&acc)[64], int, const Ring<kStages>&) const {
        const int tid = threadIdx.x, lane = tid % 32;
        const int rw = 64 * (tid / 128) + 16 * ((tid / 32) % 4) + (lane >> 2);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int t = m0 + rw + 8 * h;
            if (t >= t_out) continue;
            const size_t row = ((size_t)b * t_out + t) * C;
#pragma unroll
            for (int n = 0; n < 16; ++n) {
                const int col = n0 + 8 * n + 2 * (lane & 3);
                const float v0 = acc[4 * n + 2 * h], v1 = acc[4 * n + 2 * h + 1];
                if (kPre) *reinterpret_cast<float2*>(pre + row + col) = make_float2(v0, v1);
                *reinterpret_cast<float2*>(y + row + col) =
                    kGelu ? make_float2(usk::gelu_erf(v0), usk::gelu_erf(v1)) : make_float2(v0, v1);
            }
        }
    }
};

template <bool kGelu, bool kPre>
__global__ void __launch_bounds__(kThreads, 1) conv_gemm_f32_kernel(
    const __grid_constant__ FwdMaps maps, const float* __restrict__ wt, float* __restrict__ y,
    float* __restrict__ pre, int t_out, int C, int k) {
    extern __shared__ unsigned char conv_f32_smem[];
    const Ring<kStages> ring = ring_setup<kStages>(conv_f32_smem);
    FwdOp<kGelu, kPre> op;
    op.maps = &maps;
    op.wt = wt;
    op.y = y;
    op.pre = pre;
    op.t_out = t_out;
    op.C = C;
    op.kC = k * C;
    op.n0 = blockIdx.x * kBN;
    op.m0 = blockIdx.y * kBM;
    op.b = blockIdx.z;
    gemm(op, ring, k * C / kBK);
}

// the even/odd row views of src (B, rows, C) fp32 (row stride 2C), boxes of
// 32 channels x box_rows rows; the views' rows cut at even_rows / odd_rows
bool parity_maps(CUtensorMap* even, CUtensorMap* odd, const void* src, int B, int rows, int C,
                 uint32_t box_rows, uint64_t even_rows, uint64_t odd_rows) {
    const uint64_t strides[2] = {(uint64_t)2 * C * 4, (uint64_t)rows * C * 4};
    const uint64_t even_dims[3] = {(uint64_t)C, even_rows, (uint64_t)B};
    const uint64_t odd_dims[3] = {(uint64_t)C, odd_rows, (uint64_t)B};
    const uint32_t box[3] = {(uint32_t)kBK, box_rows, 1};
    const float* x = (const float*)src;
    return usk::make_tensor_map(even, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, x, even_dims, strides,
                                box, CU_TENSOR_MAP_SWIZZLE_128B) &&
           usk::make_tensor_map(odd, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, x + C, odd_dims, strides,
                                box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <bool kGelu, bool kPre>
cudaError_t launch_gemm(const void* src, const void* wt, void* y, void* pre, int B, int rows,
                        int t_out, int C, int k, cudaStream_t st) {
    FwdMaps maps;
    if (!parity_maps(&maps.even, &maps.odd, src, B, rows, C, kBM, (uint64_t)(rows + 1) / 2,
                     (uint64_t)rows / 2))
        return cudaErrorInvalidValue;
    auto kernel = conv_gemm_f32_kernel<kGelu, kPre>;
    constexpr int smem = (int)ring_bytes(kStages);
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    // channel tiles fastest: the tiles sharing an A row block run together
    const dim3 grid(C / kBN, (t_out + kBM - 1) / kBM, B);
    kernel<<<grid, kThreads, smem, st>>>(maps, (const float*)wt, (float*)y, (float*)pre, t_out,
                                          C, k);
    return cudaGetLastError();
}

size_t grid_for(size_t n) {
    const size_t cap = (size_t)usk::sm_count() * 16;
    const size_t g = (n + 255) / 256;
    return g < cap ? g : cap;
}

cudaError_t launch_h(const void* x, const void* a, const void* b, void* h, int B, int ts,
                     int valid, int C, bool gelu_in, cudaStream_t s) {
    const size_t n_vec = (size_t)B * valid * C / kVec;
    const size_t grid = grid_for(n_vec);
    const float *xf = (const float*)x, *af = (const float*)a, *bf = (const float*)b;
    float* hf = (float*)h;
    if (a != nullptr && gelu_in)
        conv_h_f32_kernel<true, true><<<grid, 256, 0, s>>>(xf, af, bf, hf, ts, valid, C, n_vec);
    else if (a != nullptr)
        conv_h_f32_kernel<true, false><<<grid, 256, 0, s>>>(xf, af, bf, hf, ts, valid, C, n_vec);
    else
        conv_h_f32_kernel<false, true><<<grid, 256, 0, s>>>(xf, af, bf, hf, ts, valid, C, n_vec);
    return cudaGetLastError();
}

// ------------------------------------------------------------------ backward

struct DxMaps {
    CUtensorMap g;       // g (B, t_out, C): dims {C, t_out, B}, boxes of 32 x 128
    CUtensorMap xe, xo;  // x's even / odd rows (the first block's epilogue), boxes of 32 x 128
};

// the first block's dx: three slots, then the x tile of one parity (64 KB),
// its barrier and the affine's a and b columns of the block
constexpr int kDxXStages = 3;
constexpr uint32_t kDxXTile = kBM * kBN * 4;
constexpr uint32_t kDxXExtra = 8 + kDxXTile + 2 * kBN * 4;

// dx of 128 rows t' of both input-row parities: stages [0, nk0) parity 0
// (tap 0, then tap 2 when k = 3), [nk0, nk) parity 1 (tap 1), each C / 32
// stages over the output channels. With the affine or the input GELU (the
// first block) the epilogue reads x^'s rows from a tile of x that TMA loads
// while the parity's products run.
template <bool kAffine, bool kGeluIn>
struct DxOp {
    static constexpr bool kX = kAffine || kGeluIn;
    static constexpr int kS = kX ? kDxXStages : kStages;
    const DxMaps* maps;
    const float* w;        // (k, C_in, C_out)
    unsigned char* xtile;  // shared memory: [4 channel boxes][128 rows][32] of x, swizzled
    uint64_t* xbar;
    const float* aff;      // shared memory: a, then b, of the block's kBN columns
    float* dx;
    float* da;                // (B, C) zeroed, or null
    float* db;
    int ts, valid, C, steps, nk0, m0, n0, b;

    __device__ int tap(int j) const { return j < nk0 ? (j < steps ? 0 : 2) : 1; }
    __device__ void load_a(int j, unsigned char* dst, uint64_t* bar) const {
        const int p = tap(j);
        // tap 2 reads g row t' - 1: the box at m0 - 1 (row -1 loads as zeros)
        usk::tma_load_3d(dst, &maps->g, bar, (j % steps) * kBK, m0 - (p >> 1), b);
    }
    // x's rows 2t' + par of the block's rows t' and channels, issued by one thread
    __device__ void load_x(int par) const {
        usk::mbar_expect_tx(xbar, kDxXTile);
#pragma unroll
        for (int i = 0; i < 4; ++i)
            usk::tma_load_3d(xtile + i * (kDxXTile / 4), par ? &maps->xo : &maps->xe, xbar,
                             n0 + 32 * i, m0, b);
    }
    __device__ void load_b(int j, int tid, float4 (&v)[4]) const {
        load_rows(w + ((size_t)tap(j) * C + n0) * C, C, (j % steps) * kBK, tid, v);
    }
    __device__ void store_b(int tid, const float4 (&v)[4], unsigned char* hi,
                            unsigned char* lo) const {
        store_rows(tid, v, hi, lo);
    }
    __device__ uint32_t a_off(int r, int c) const { return usk::sw_tf32(r, c, kBM); }
    __device__ bool segment_end(int ks, int nk) const { return ks == nk0 - 1 || ks == nk - 1; }
    __device__ void epilogue(const float (&acc)[64], int ks, const Ring<kS>&) const {
        const int par = ks < nk0 ? 0 : 1;
        const int tid = threadIdx.x, lane = tid % 32, gq = lane >> 2, c2 = 2 * (lane & 3);
        int row[2], rl[2];
        bool in_ts[2], in_valid[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            rl[h] = 64 * (tid / 128) + 16 * ((tid / 32) % 4) + gq + 8 * h;
            row[h] = 2 * (m0 + rl[h]) + par;
            in_ts[h] = row[h] < ts;
            in_valid[h] = row[h] < valid;
        }
        if (kX) usk::mbar_wait(xbar, par);
#pragma unroll
        for (int jp = 0; jp < 8; ++jp) {
            // v * x and v of this lane's rows per (slice jj, column q):
            // sums[jj * 4 + q] (da), sums[jj * 4 + 2 + q] (db)
            float sums[8];
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
                const int j = 2 * jp + jj, n = n0 + 8 * j + c2;
                float sa[2] = {0.f, 0.f}, sb[2] = {0.f, 0.f};
                float2 av = make_float2(1.f, 1.f), bv = make_float2(0.f, 0.f);
                if (kAffine) {
                    av = *reinterpret_cast<const float2*>(aff + 8 * j + c2);
                    bv = *reinterpret_cast<const float2*>(aff + kBN + 8 * j + c2);
                }
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    if (!in_ts[h]) continue;
                    float* dst = dx + ((size_t)b * ts + row[h]) * C + n;
                    if (!in_valid[h]) {
                        *reinterpret_cast<float2*>(dst) = make_float2(0.f, 0.f);
                        continue;
                    }
                    float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
                    if (kX) {
                        const int c = 8 * (j & 3) + c2;  // in x's channel box j / 4
                        const float2 xr = *reinterpret_cast<const float2*>(
                            xtile + (j >> 2) * (kDxXTile / 4) + rl[h] * 128 +
                            ((((c >> 2) ^ (rl[h] & 7)) << 4) | ((c & 3) * 4)));
                        if (kGeluIn) {
                            // x^ as the H pass forms it: mul then add, each rounded
                            const float h0 = kAffine ? __fadd_rn(__fmul_rn(xr.x, av.x), bv.x) : xr.x;
                            const float h1 = kAffine ? __fadd_rn(__fmul_rn(xr.y, av.y), bv.y) : xr.y;
                            v0 = __fmul_rn(v0, usk::dgelu_erf(h0));
                            v1 = __fmul_rn(v1, usk::dgelu_erf(h1));
                        }
                        if (kAffine) {
                            sa[0] = fmaf(v0, xr.x, sa[0]);
                            sa[1] = fmaf(v1, xr.y, sa[1]);
                            sb[0] += v0;
                            sb[1] += v1;
                            v0 = __fmul_rn(v0, av.x);
                            v1 = __fmul_rn(v1, av.y);
                        }
                    }
                    *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
                }
                sums[jj * 4] = sa[0];
                sums[jj * 4 + 1] = sa[1];
                sums[jj * 4 + 2] = sb[0];
                sums[jj * 4 + 3] = sb[1];
            }
            if (kAffine) {
                // over the warp's 16 rows (the 8 lanes of one c2): a
                // reduce-scatter in 7 shuffles leaves lane gq with the total
                // of sums[gq]; one global add per lane
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
        if (kX && par == 0) {  // every thread is done with x's even rows
            __syncthreads();
            if (tid == 0) load_x(1);
        }
    }
};

template <bool kAffine, bool kGeluIn>
__global__ void __launch_bounds__(kThreads, 1) conv_bwd_dx_f32_kernel(
    const __grid_constant__ DxMaps maps, const float* __restrict__ w,
    const float* __restrict__ aa, const float* __restrict__ ab, float* __restrict__ dx,
    float* __restrict__ da, float* __restrict__ db, int ts, int valid, int C, int k) {
    using Op = DxOp<kAffine, kGeluIn>;
    extern __shared__ unsigned char conv_f32_smem[];
    const Ring<Op::kS> ring = ring_setup<Op::kS>(conv_f32_smem);
    Op op;
    op.maps = &maps;
    op.n0 = blockIdx.x * kBN;
    op.m0 = blockIdx.y * kBM;
    op.b = blockIdx.z;
    // behind the barriers: x's barrier, the x tile (1024-byte aligned), the affine
    op.xbar = reinterpret_cast<uint64_t*>(ring.extra());
    op.xtile = ring.smem + ((ring.extra() - ring.smem + 8 + 1023) & ~1023);
    float* aff = reinterpret_cast<float*>(op.xtile + kDxXTile);
    if (Op::kX) {
        if (threadIdx.x == 0) {
            usk::mbar_init(op.xbar, 1);
            usk::fence_barrier_init();
        }
        if (kAffine && threadIdx.x < kBN) {
            aff[threadIdx.x] = aa[(size_t)op.b * C + op.n0 + threadIdx.x];
            aff[kBN + threadIdx.x] = ab[(size_t)op.b * C + op.n0 + threadIdx.x];
        }
        __syncthreads();
        if (threadIdx.x == 0) op.load_x(0);
    }
    op.w = w;
    op.aff = aff;
    op.dx = dx;
    op.da = da;
    op.db = db;
    op.ts = ts;
    op.valid = valid;
    op.C = C;
    op.steps = C / kBK;
    op.nk0 = (k == 3 ? 2 : 1) * op.steps;
    gemm(op, ring, op.nk0 + op.steps);
}

struct DwMaps {
    CUtensorMap even;  // H rows 2r:   dims {C, even rows, B}, boxes of 32 x 32
    CUtensorMap odd;   // H rows 2r+1: dims {C, odd rows, B}
    CUtensorMap dw;    // fp32 dW (k, C_in, C_out): dims {C_out, C_in, k}, boxes of 32 x 64
};

constexpr uint32_t kDwBox = 32 * 32 * 4;     // one 32-row x 32-channel box of H
constexpr uint32_t kStageBox = 64 * 32 * 4;  // one 64 x 32 box of a dW tile

// dW_p over the steps [s_lo, s_lo + nk) of the B * nkb 32-row steps
// (step = b * nkb + t / 32): a (128 in x 128 out) tile per block
struct DwOp {
    const DwMaps* maps;
    const float* g;  // (B, t_out, C)
    int t_out, C, nkb, s_lo, p, m0, n0;

    __device__ void load_a(int j, unsigned char* dst, uint64_t* bar) const {
        const int step = s_lo + j, bq = step / nkb, t0 = (step - bq * nkb) * kBK;
        // H row 2t + p: even row t (p = 0), odd row t (p = 1), even row t + 1 (p = 2)
        const CUtensorMap* hmap = p == 1 ? &maps->odd : &maps->even;
#pragma unroll
        for (int i = 0; i < 4; ++i)
            usk::tma_load_3d(dst + i * kDwBox, hmap, bar, m0 + 32 * i, t0 + (p >> 1), bq);
    }
    // unit tid: rows t0 + 4 (tid % 8) .. + 3 of g, channels n0 + 4 (tid / 8) .. + 3
    __device__ void load_b(int j, int tid, float4 (&v)[4]) const {
        const int step = s_lo + j, bq = step / nkb, t0 = (step - bq * nkb) * kBK;
        const int t = t0 + 4 * (tid & 7);
        const float* src = g + ((size_t)bq * t_out + t) * C + n0 + 4 * (tid >> 3);
#pragma unroll
        for (int r = 0; r < 4; ++r)
            v[r] = t + r < t_out ? __ldg(reinterpret_cast<const float4*>(src + (size_t)r * C))
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    // transposed: row n of the K-major tile is output channel n, its K the rows
    __device__ void store_b(int tid, const float4 (&v)[4], unsigned char* hi,
                            unsigned char* lo) const {
        const int kr = 4 * (tid & 7), n = 4 * (tid >> 3);
        store_split(hi, lo, usk::sw_tf32(n, kr, kBN), make_float4(v[0].x, v[1].x, v[2].x, v[3].x));
        store_split(hi, lo, usk::sw_tf32(n + 1, kr, kBN), make_float4(v[0].y, v[1].y, v[2].y, v[3].y));
        store_split(hi, lo, usk::sw_tf32(n + 2, kr, kBN), make_float4(v[0].z, v[1].z, v[2].z, v[3].z));
        store_split(hi, lo, usk::sw_tf32(n + 3, kr, kBN), make_float4(v[0].w, v[1].w, v[2].w, v[3].w));
    }
    // A[r][c] = H[row c][channel m0 + r]: box r / 32, its row c, column r % 32
    __device__ uint32_t a_off(int r, int c) const {
        return (uint32_t)(r >> 5) * kDwBox + (uint32_t)c * 128u +
               (((((uint32_t)r & 31u) >> 2) ^ ((uint32_t)c & 7u)) << 4) + ((uint32_t)r & 3u) * 4u;
    }
    __device__ bool segment_end(int ks, int nk) const { return ks == nk - 1; }
    // the ring is free once both warpgroups' products are done: stage this
    // warpgroup's 64 x 128 tile there as four swizzled 64 x 32 boxes, then
    // add them into dW by TMA reductions
    __device__ void epilogue(const float (&acc)[64], int, const Ring<kStages>& ring) const {
        __syncthreads();
        const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
        unsigned char* stg = ring.smem + wg * 4 * kStageBox;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = 16 * ((tid / 32) % 4) + (lane >> 2) + 8 * h;
#pragma unroll
            for (int n = 0; n < 16; ++n) {
                const int c = (n & 3) * 8 + 2 * (lane & 3);
                *reinterpret_cast<float2*>(stg + (n >> 2) * kStageBox + r * 128 +
                                           ((((c >> 2) ^ (r & 7)) << 4) | ((c & 3) * 4))) =
                    make_float2(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
            }
        }
        usk::fence_proxy_async();
        usk::named_bar_sync(1 + wg, 128);
        if (tid % 128 == 0) {
#pragma unroll
            for (int bx = 0; bx < 4; ++bx)
                usk::tma_reduce_add_3d(&maps->dw, stg + bx * kStageBox, n0 + 32 * bx, m0 + 64 * wg, p);
            usk::bulk_commit();
            usk::bulk_wait();
        }
    }
};

__global__ void __launch_bounds__(kThreads, 1) conv_bwd_dw_f32_kernel(
    const __grid_constant__ DwMaps maps, const float* __restrict__ g, int t_out, int C, int k,
    int nkb, int total_steps, int per_split) {
    extern __shared__ unsigned char conv_f32_smem[];
    const Ring<kStages> ring = ring_setup<kStages>(conv_f32_smem);
    DwOp op;
    op.maps = &maps;
    op.g = g;
    op.t_out = t_out;
    op.C = C;
    op.nkb = nkb;
    op.p = blockIdx.z % k;
    op.s_lo = (blockIdx.z / k) * per_split;
    op.n0 = blockIdx.x * kBN;
    op.m0 = blockIdx.y * kBM;
    gemm(op, ring, min(per_split, total_steps - op.s_lo));
}

// g (B, t_out, C) fp32 with boxes of 32 channels x box_rows rows
bool g_map(CUtensorMap* m, const void* g, int B, int t_out, int C, uint32_t box_rows) {
    const uint64_t dims[3] = {(uint64_t)C, (uint64_t)t_out, (uint64_t)B};
    const uint64_t strides[2] = {(uint64_t)C * 4, (uint64_t)t_out * C * 4};
    const uint32_t box[3] = {(uint32_t)kBK, box_rows, 1};
    return usk::make_tensor_map(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, g, dims, strides, box,
                                CU_TENSOR_MAP_SWIZZLE_128B);
}

template <bool kAffine, bool kGeluIn>
cudaError_t launch_dx(const void* g, const void* w, const void* x, const void* a, const void* b,
                      void* dx, void* da, void* db, int B, int ts, int valid, int t_out, int C,
                      int k, cudaStream_t st) {
    using Op = DxOp<kAffine, kGeluIn>;
    DxMaps maps;
    if (!g_map(&maps.g, g, B, t_out, C, kBM) ||
        !parity_maps(&maps.xe, &maps.xo, x, B, ts, C, kBM, (uint64_t)(ts + 1) / 2,
                     (uint64_t)ts / 2))
        return cudaErrorInvalidValue;
    auto kernel = conv_bwd_dx_f32_kernel<kAffine, kGeluIn>;
    // the x tile 1024-byte aligned behind the barriers
    const int smem = Op::kX ? (int)ring_bytes(Op::kS, 1024 + kDxXExtra) : (int)ring_bytes(Op::kS);
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    // both parities of 128 rows t' per block: ceil(ts / 2) rows cover every input row
    const dim3 grid(C / kBN, ((ts + 1) / 2 + kBM - 1) / kBM, B);
    kernel<<<grid, kThreads, smem, st>>>(maps, (const float*)w, (const float*)a, (const float*)b,
                                         (float*)dx, (float*)da, (float*)db, ts, valid, C, k);
    return cudaGetLastError();
}

cudaError_t launch_dw(const void* h, const void* g, void* dw, int B, int th, int t_out, int C,
                      int k, int per_split, cudaStream_t st) {
    DwMaps maps;
    // the rows the taps reach: even rows t and t + 1, odd rows t, for t < t_out
    const uint64_t even_rows = (th + 1) / 2 < t_out + 1 ? (th + 1) / 2 : t_out + 1;
    const uint64_t odd_rows = th / 2 < t_out ? th / 2 : t_out;
    const uint64_t dw_dims[3] = {(uint64_t)C, (uint64_t)C, (uint64_t)k};
    const uint64_t dw_strides[2] = {(uint64_t)C * 4, (uint64_t)C * C * 4};
    const uint32_t dw_box[3] = {32, 64, 1};
    if (!parity_maps(&maps.even, &maps.odd, h, B, th, C, kBK, even_rows, odd_rows) ||
        !usk::make_tensor_map(&maps.dw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, dw, dw_dims,
                              dw_strides, dw_box, CU_TENSOR_MAP_SWIZZLE_128B))
        return cudaErrorInvalidValue;
    constexpr int smem = (int)ring_bytes(kStages);
    const cudaError_t err = cudaFuncSetAttribute(
        conv_bwd_dw_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const int nkb = (t_out + kBK - 1) / kBK, total = B * nkb;
    const int splits = (total + per_split - 1) / per_split;
    const dim3 grid(C / kBN, C / kBM, k * splits);
    conv_bwd_dw_f32_kernel<<<grid, kThreads, smem, st>>>(maps, (const float*)g, t_out, C, k, nkb,
                                                          total, per_split);
    return cudaGetLastError();
}

}  // namespace

// x (B, ts, C) fp32 contiguous, 16-byte aligned; w_t the weight as (C_out,
// k * C_in) fp32 contiguous; a / b (B, C) fp32 or null; h_buf (B, valid, C)
// fp32 when a or gelu_in, else null; y and pre (B, t_out, C) fp32, pre null
// unless wanted; C % 128 == 0, k in {2, 3}
extern "C" int usk_conv_gelu_block_f32(const void* x, const void* w_t, const void* a,
                                       const void* b, void* h_buf, void* y, void* pre, int B,
                                       int ts, int valid, int t_out, int C, int k, int gelu_in,
                                       int gelu_out, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (C % kBN != 0 || (k != 2 && k != 3)) return (int)cudaErrorInvalidValue;
    const void* src = x;
    int rows = ts;
    if (a != nullptr || gelu_in) {
        const cudaError_t err = launch_h(x, a, b, h_buf, B, ts, valid, C, gelu_in != 0, s);
        if (err != cudaSuccess) return (int)err;
        src = h_buf;
        rows = valid;
    }
    const int sel = (gelu_out ? 2 : 0) | (pre != nullptr ? 1 : 0);
    switch (sel) {
        case 0: return (int)launch_gemm<false, false>(src, w_t, y, pre, B, rows, t_out, C, k, s);
        case 1: return (int)launch_gemm<false, true>(src, w_t, y, pre, B, rows, t_out, C, k, s);
        case 2: return (int)launch_gemm<true, false>(src, w_t, y, pre, B, rows, t_out, C, k, s);
        default: return (int)launch_gemm<true, true>(src, w_t, y, pre, B, rows, t_out, C, k, s);
    }
}

// the block's backward in fp32: x (B, ts, C) contiguous, valid rows [0,
// valid); w (k, C, C) (the JAX (k, in, out) layout) contiguous; a / b (B, C)
// or null; dy, pre (B, t_out, C) (pre null without the output GELU); g_buf
// (B, t_out, C) scratch with pre; h_buf (B, valid, C) scratch with a or
// gelu_in; dx (B, ts, C); dw (k, C, C) zeroed; da / db (B, C) zeroed with
// a; parts: bit 1 dx, bit 2 dW; dw_per_split: 32-row steps per dW split
// (conv_stack.dw_split_plan); all fp32, 16-byte aligned; C % 128 == 0, k
// in {2, 3}
extern "C" int usk_conv_gelu_block_bwd_f32(const void* x, const void* w, const void* a,
                                           const void* b, const void* dy, const void* pre,
                                           void* g_buf, void* h_buf, void* dx, void* dw,
                                           void* da, void* db, int B, int ts, int valid,
                                           int t_out, int C, int k, int gelu_in, int parts,
                                           int dw_per_split, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (C % kBN != 0 || (k != 2 && k != 3) || dw_per_split < 1) return (int)cudaErrorInvalidValue;
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
        const cudaError_t err = launch_h(x, a, b, h_buf, B, ts, valid, C, gelu_in != 0, s);
        if (err != cudaSuccess) return (int)err;
        hsrc = h_buf;
        th = valid;
    }
    if (parts & 1) {
        cudaError_t err;
        if (a != nullptr && gelu_in)
            err = launch_dx<true, true>(gsrc, w, x, a, b, dx, da, db, B, ts, valid, t_out, C, k, s);
        else if (a != nullptr)
            err = launch_dx<true, false>(gsrc, w, x, a, b, dx, da, db, B, ts, valid, t_out, C, k, s);
        else if (gelu_in)
            err = launch_dx<false, true>(gsrc, w, x, a, b, dx, da, db, B, ts, valid, t_out, C, k, s);
        else
            err = launch_dx<false, false>(gsrc, w, x, a, b, dx, da, db, B, ts, valid, t_out, C, k, s);
        if (err != cudaSuccess) return (int)err;
    }
    if (parts & 2)
        return (int)launch_dw(hsrc, gsrc, dw, B, th, t_out, C, k, dw_per_split, s);
    return (int)cudaSuccess;
}
