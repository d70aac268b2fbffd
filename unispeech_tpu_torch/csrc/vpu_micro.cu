// Elementwise micro-benchmark: one pass y = bf16(fn(fp32(x))) over a bf16
// tensor, for seven functions fn (copy, exp and the GELU forms the conv
// chain could use).
//
// Replaces scripts/exp_vpu_micro.py::run (its Pallas kernel _kern over
// (1, 512, C) blocks). The functions follow the TPU script's operation
// order in fp32, one rounding per operation (no FMA contraction), with the
// coefficients of unispeech_tpu/ops/pallas/conv_stack.py (_EC, _DC) and of
// the script (_EC6, the Abramowitz-Stegun erf) as fp32 hex literals, so
// the plain PyTorch version in ops/kernels/vpu_micro.py computes the same
// values (exp may differ by one fp32 ulp).
//
// Bound on the H100: bytes. One pass reads and writes 2 bytes per element:
// at (6, 49152, 512) 604 MB, 0.180 ms at 3.35 TB/s. The arithmetic of the
// longer variants (gelu_AS_exp: an exp, a reciprocal and ~25 fp32
// operations per element) comes close to that time at one instruction per
// lane and cycle, so every instruction counts: the reciprocal is
// __frcp_rn (correctly rounded, the same bits as 1 / d), not a division.
// The last n % 8 elements go through a scalar tail.

#include "common.cuh"
#include "hopper.cuh"

namespace {

enum Variant { kCopy = 0, kExp, kGeluPoly8, kGeluPoly6c, kGeluAsExp, kDgeluPoly8, kGeluDgelu6 };

// Horner in s from the highest coefficient: acc = acc * s + c
template <int N>
__device__ __forceinline__ float poly_s(const float (&c)[N], float s) {
    float acc = c[N - 1];
#pragma unroll
    for (int i = N - 2; i >= 0; --i) acc = __fadd_rn(__fmul_rn(acc, s), c[i]);
    return acc;
}

// conv_stack.py _EC / _DC (degree 8 in s = x^2), exp_vpu_micro.py _EC6;
// local arrays with unrolled loops fold to immediates
__device__ __forceinline__ float poly_ec(float s) {
    const float c[9] = {0x1.9883b4p-1f, -0x1.103ca4p-3f, 0x1.453eaap-6f, -0x1.2e5516p-9f,
                        0x1.b01cdap-13f, -0x1.c79be0p-17f, 0x1.47d4ecp-21f,
                        -0x1.1a774ep-26f, 0x1.b2259ep-33f};
    return poly_s(c, s);
}
__device__ __forceinline__ float poly_dc(float s) {
    const float c[9] = {0x1.987fd4p-1f, -0x1.0ff46ep-2f, 0x1.e47688p-5f, -0x1.26a388p-7f,
                        0x1.fa7014p-11f, -0x1.2e0ba4p-14f, 0x1.d72fa8p-19f,
                        -0x1.abf3c6p-24f, 0x1.54a1bep-30f};
    return poly_s(c, s);
}
__device__ __forceinline__ float poly_ec6(float s) {
    const float c[7] = {0x1.98734cp-1f, -0x1.0e7c20p-3f, 0x1.35a994p-6f, -0x1.f3e2c8p-10f,
                        0x1.049c52p-13f, -0x1.344380p-18f, 0x1.35d650p-24f};
    return poly_s(c, s);
}

__device__ __forceinline__ float clamp4(float x) { return fminf(fmaxf(x, -4.0f), 4.0f); }

// 0.5 * x * (1 + e), left to right
__device__ __forceinline__ float half_x_one_plus(float x, float e) {
    return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, e));
}

__device__ __forceinline__ float gelu_poly8(float x) {
    const float xc = clamp4(x);
    return half_x_one_plus(x, __fmul_rn(xc, poly_ec(__fmul_rn(xc, xc))));
}

__device__ __forceinline__ float gelu_poly6c(float x) {
    const float t = clamp4(x);
    return half_x_one_plus(x, __fmul_rn(t, poly_ec6(__fmul_rn(t, t))));
}

__device__ __forceinline__ float dgelu_poly8(float x) {
    const float xc = clamp4(x);
    return __fadd_rn(0.5f, __fmul_rn(xc, poly_dc(__fmul_rn(xc, xc))));
}

__device__ __forceinline__ float gelu_as_exp(float x) {
    const float a1 = 0x1.04f20cp-2f, a2 = -0x1.23531cp-2f, a3 = 0x1.6be1c6p+0f,
                a4 = -0x1.7401c6p+0f, a5 = 0x1.0fb844p+0f, p = 0x1.4f740ap-2f;
    const float z = __fmul_rn(x, 0x1.6a09e6p-1f);
    const float az = fabsf(z);
    const float t = __frcp_rn(__fadd_rn(1.0f, __fmul_rn(p, az)));  // d >= 1
    float poly = __fadd_rn(__fmul_rn(a5, t), a4);
    poly = __fadd_rn(__fmul_rn(poly, t), a3);
    poly = __fadd_rn(__fmul_rn(poly, t), a2);
    poly = __fadd_rn(__fmul_rn(poly, t), a1);
    poly = __fmul_rn(poly, t);
    float e = __fsub_rn(1.0f, __fmul_rn(poly, expf(-__fmul_rn(az, az))));
    const float sgn = z > 0.f ? 1.f : (z < 0.f ? -1.f : 0.f);
    e = __fmul_rn(sgn, e);
    return half_x_one_plus(x, e);
}

template <int V>
__device__ __forceinline__ float apply(float x) {
    if (V == kCopy) return x;
    if (V == kExp) return expf(x);
    if (V == kGeluPoly8) return gelu_poly8(x);
    if (V == kGeluPoly6c) return gelu_poly6c(x);
    if (V == kGeluAsExp) return gelu_as_exp(x);
    if (V == kDgeluPoly8) return dgelu_poly8(x);
    return __fadd_rn(gelu_poly6c(x), dgelu_poly8(x));
}

// Design, for all variants but gelu+dgelu6: a register stream. Each thread
// issues kUnroll 16-byte loads that skip L1 before it computes, and stores
// with the streaming hint; block j takes step j of kThreads x kUnroll
// vectors, so the blocks the card holds at once, and each one that replaces
// a finished one, advance through memory together. (Measured slower on the
// H100: the same loop over the resident blocks only, each walking one
// contiguous chunk or every grid-th step.) gelu+dgelu6, whose arithmetic
// takes about as long as its bytes, runs faster through a bulk-copy ring
// (vpu_ring_kernel), the other variants slower.
constexpr int kThreads = 256;
constexpr int kUnroll = 2;  // 16-byte loads in flight per thread (4: 1% slower)
constexpr size_t kStep = (size_t)kThreads * kUnroll;  // vectors per block

__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
    uint4 v;
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
    return v;
}

template <int V>
__global__ void __launch_bounds__(kThreads) vpu_micro_kernel(
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ y, size_t n) {
    const size_t n_vec = n / 8;
    const size_t i0 = blockIdx.x * kStep + threadIdx.x;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    uint4* yv = reinterpret_cast<uint4*>(y);
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
        const size_t i = i0 + (size_t)u * kThreads;
        v[u] = i < n_vec ? ld_stream(xv + i) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v[u]);
#pragma unroll
        for (int q = 0; q < 8; ++q) e[q] = usk::f2bf(apply<V>(usk::bf2f(e[q])));
        const size_t i = i0 + (size_t)u * kThreads;
        if (i < n_vec) usk::st_stream(yv + i, v[u]);
    }
    // the last n % 8 elements
    const size_t t = n_vec * 8 + threadIdx.x;
    if (blockIdx.x == gridDim.x - 1 && t < n) y[t] = usk::f2bf(apply<V>(usk::bf2f(x[t])));
}

constexpr int kRingStages = 6;
constexpr int kRingChunk = 32768;  // bytes per stage
constexpr int kRingConsumers = 512;
constexpr size_t kRingSmem = (size_t)kRingStages * kRingChunk + 2 * kRingStages * 8;

// One block per SM; chunk c of the vector part goes to block c % gridDim.x.
// One thread moves the block's chunks global -> shared and back with
// cp.async.bulk (the copies take no registers) while 16 warps transform
// each chunk in place; a stage is refilled once its store has read it.
template <int V>
__global__ void __launch_bounds__(kRingConsumers + 32, 1) vpu_ring_kernel(
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ y, size_t n) {
    extern __shared__ __align__(1024) unsigned char ring[];
    uint64_t* full = reinterpret_cast<uint64_t*>(ring + kRingStages * kRingChunk);
    uint64_t* done = full + kRingStages;
    const size_t n_bytes = n / 8 * 16;
    const size_t n_chunks = (n_bytes + kRingChunk - 1) / kRingChunk;
    const int mine = blockIdx.x < n_chunks
                         ? (int)((n_chunks - 1 - blockIdx.x) / gridDim.x + 1) : 0;
    if (threadIdx.x == 0) {
        for (int s = 0; s < kRingStages; ++s) {
            usk::mbar_init(&full[s], 1);
            usk::mbar_init(&done[s], kRingConsumers);
        }
        usk::fence_barrier_init();
    }
    __syncthreads();
    auto chunk_of = [&](int i) { return (size_t)blockIdx.x + (size_t)i * gridDim.x; };
    auto bytes_of = [&](size_t c) {
        const size_t left = n_bytes - c * kRingChunk;
        return (uint32_t)(left < (size_t)kRingChunk ? left : kRingChunk);
    };
    auto load = [&](int i) {
        const int s = i % kRingStages;
        const size_t c = chunk_of(i);
        usk::mbar_expect_tx(&full[s], bytes_of(c));
        usk::bulk_load(ring + s * kRingChunk,
                       reinterpret_cast<const unsigned char*>(x) + c * kRingChunk, bytes_of(c),
                       &full[s]);
    };
    if (threadIdx.x == kRingConsumers) {  // the copying thread
        for (int i = 0; i < kRingStages - 1 && i < mine; ++i) load(i);
        for (int i = 0; i < mine; ++i) {
            // chunk i is transformed: write it back, then refill the stage of
            // chunk i - 1, whose store has read it once at most the newest
            // bulk group is pending
            const int s = i % kRingStages;
            usk::mbar_wait(&done[s], (i / kRingStages) & 1);
            const size_t c = chunk_of(i);
            usk::bulk_store(reinterpret_cast<unsigned char*>(y) + c * kRingChunk,
                            ring + s * kRingChunk, bytes_of(c));
            usk::bulk_commit();
            if (i + kRingStages - 1 < mine) {
                usk::bulk_wait_read<1>();
                load(i + kRingStages - 1);
            }
        }
        usk::bulk_wait();
    } else if (threadIdx.x < kRingConsumers) {
        for (int i = 0; i < mine; ++i) {
            const int s = i % kRingStages;
            usk::mbar_wait(&full[s], (i / kRingStages) & 1);
            uint4* p = reinterpret_cast<uint4*>(ring + s * kRingChunk);
            const int nv = (int)(bytes_of(chunk_of(i)) / 16);
            for (int j = threadIdx.x; j < nv; j += kRingConsumers) {
                uint4 v = p[j];
                __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
                for (int q = 0; q < 8; ++q) e[q] = usk::f2bf(apply<V>(usk::bf2f(e[q])));
                p[j] = v;
            }
            usk::fence_proxy_async();  // the transformed chunk, for the bulk store
            usk::mbar_arrive(&done[s]);
        }
        const size_t t = n / 8 * 8 + threadIdx.x;  // the last n % 8 elements
        if (blockIdx.x == 0 && t < n) y[t] = usk::f2bf(apply<V>(usk::bf2f(x[t])));
    }
}

template <int V>
cudaError_t launch(const void* x, void* y, size_t n, cudaStream_t stream) {
    if constexpr (V == kGeluDgelu6) {
        const cudaError_t err = cudaFuncSetAttribute(
            vpu_ring_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kRingSmem);
        if (err != cudaSuccess) return err;
        vpu_ring_kernel<V><<<usk::sm_count(), kRingConsumers + 32, kRingSmem, stream>>>(
            (const __nv_bfloat16*)x, (__nv_bfloat16*)y, n);
    } else {
        const size_t steps = (n / 8 + kStep - 1) / kStep;
        vpu_micro_kernel<V><<<(unsigned)(steps > 0 ? steps : 1), kThreads, 0, stream>>>(
            (const __nv_bfloat16*)x, (__nv_bfloat16*)y, n);
    }
    return cudaGetLastError();
}

}  // namespace

// variant: 0 copy, 1 exp, 2 gelu_poly8, 3 gelu_poly6c, 4 gelu_AS_exp,
// 5 dgelu_poly8, 6 gelu+dgelu6; x and y 16-byte aligned, n elements
extern "C" int usk_vpu_micro(int variant, const void* x, void* y, long long n, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    const size_t m = (size_t)n;
    switch (variant) {
        case kCopy: return (int)launch<kCopy>(x, y, m, s);
        case kExp: return (int)launch<kExp>(x, y, m, s);
        case kGeluPoly8: return (int)launch<kGeluPoly8>(x, y, m, s);
        case kGeluPoly6c: return (int)launch<kGeluPoly6c>(x, y, m, s);
        case kGeluAsExp: return (int)launch<kGeluAsExp>(x, y, m, s);
        case kDgeluPoly8: return (int)launch<kDgeluPoly8>(x, y, m, s);
        case kGeluDgelu6: return (int)launch<kGeluDgelu6>(x, y, m, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
