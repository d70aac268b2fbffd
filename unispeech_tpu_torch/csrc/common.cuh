// Shared helpers for the port's Hopper kernels (sm_90a, bound by ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace usk {

__device__ __forceinline__ float bf2f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ __nv_bfloat16 f2bf(float x) { return __float2bfloat16_rn(x); }
// round an fp32 value through bf16 (the storage dtype) and back
__device__ __forceinline__ float round_bf16(float x) { return bf2f(f2bf(x)); }

// 2^x by the special-function unit (relative error ~2^-22; subnormal
// results flush to 0, -inf gives 0)
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// a 16-byte store that streams past the caches (written once, not re-read soon)
__device__ __forceinline__ void st_stream(void* p, uint4 v) {
    asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};"
                 :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

// the current device's SM count (host), for persistent grids
inline int sm_count() {
    static int n = 0;
    if (n == 0) {
        int dev = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
            n = 132;
    }
    return n;
}

// exact (erf) GELU in fp32; the TPU kernels use a polynomial only because
// Mosaic has no erf
__device__ __forceinline__ float gelu_erf(float x) {
    return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

// its exact derivative Phi(x) + x * phi(x)
__device__ __forceinline__ float dgelu_erf(float x) {
    return 0.5f * (1.0f + erff(x * 0.70710678118654752f)) +
           x * 0.39894228040143268f * expf(-0.5f * x * x);
}

}  // namespace usk
