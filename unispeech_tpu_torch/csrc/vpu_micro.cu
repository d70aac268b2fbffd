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
// at (6, 49152, 512) 604 MB, 0.180 ms at 3.35 TB/s; the heaviest variant
// (gelu+dgelu6, ~40 fp32 operations per element) needs 0.090 ms of the
// 67 TFLOP/s fp32 rate. Design: a grid-stride loop over 16-byte vectors
// (8 bf16 per thread per iteration), about 16 blocks of 256 threads per SM
// so that enough loads are in flight to cover the memory latency; the
// last n % 8 elements go through a scalar tail.

#include "common.cuh"

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
    const float t = __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(p, az)));
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

constexpr int kThreads = 256;

template <int V>
__global__ void __launch_bounds__(kThreads) vpu_micro_kernel(
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ y, size_t n) {
    const size_t n_vec = n / 8;
    const size_t stride = (size_t)gridDim.x * blockDim.x;
    const size_t first = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    for (size_t i = first; i < n_vec; i += stride) {
        uint4 v = reinterpret_cast<const uint4*>(x)[i];
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
        for (int q = 0; q < 8; ++q) e[q] = usk::f2bf(apply<V>(usk::bf2f(e[q])));
        reinterpret_cast<uint4*>(y)[i] = v;
    }
    const size_t tail = n_vec * 8 + first;
    if (tail < n) y[tail] = usk::f2bf(apply<V>(usk::bf2f(x[tail])));
}

template <int V>
cudaError_t launch(const void* x, void* y, size_t n, cudaStream_t stream) {
    const size_t want = (n / 8 + kThreads - 1) / kThreads;
    const int grid = (int)(want < 1 ? 1 : (want > 132 * 16 ? 132 * 16 : want));
    vpu_micro_kernel<V><<<grid, kThreads, 0, stream>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)y, n);
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
