// fp32 products on the tensor cores for the port's fp32 kernels: the
// 3xTF32 split on mma.sync.m16n8k8, tiles split once for wgmma (TF32) in
// the 128-byte swizzle, and cp.async copies into shared memory.
//
// A single TF32 product keeps 11 significant bits of each operand (~1e-3
// relative error), so it is not an fp32 product. The split a = hi + lo,
// hi = tf32(a), lo = tf32(a - hi) (both rounded to nearest) keeps ~22 bits;
// a.b = hi.hi + hi.lo + lo.hi (+ lo.lo, ~2^-22 relative, dropped) with fp32
// accumulation is fp32 to within a few ulps of the sum, at three tensor-core
// products per fragment and k step, and one CUDA-core add.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace usk {

__device__ __forceinline__ uint32_t tf32_rna(float a) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
    return r;
}

// a = hi + lo to ~22 significant bits
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
    hi = tf32_rna(a);
    lo = tf32_rna(a - __uint_as_float(hi));
}

// D (16 x 8 fp32) += A (16 x 8 tf32, row) . B (8 x 8 tf32, col), one warp:
// lane (g = lane / 4, t = lane % 4) holds a = {A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]}, b = {B[t][g], B[t+4][g]}, d = {D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1]}
__device__ __forceinline__ void mma_tf32_1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D = A . B, the accumulator not read (zero)
__device__ __forceinline__ void mma_tf32_1688_zero(float (&d)[4], const uint32_t (&a)[4],
                                                   uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// d += a . b in fp32 from split operands. The three products (the small
// ones first) go into a fresh sum, which one round-to-nearest fp32 add
// then adds to d: the tensor cores' own fp32 accumulation truncates, and
// into a long running sum each step's truncation biases it toward zero
// (1.2e-5 relative over K = 1536 on an H100, against ~1e-6 this way).
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
    float t[4];
    mma_tf32_1688_zero(t, al, bh0, bh1);
    mma_tf32_1688(t, ah, bl0, bl1);
    mma_tf32_1688(t, ah, bh0, bh1);
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i] += t[i];
}

// A tile split once for TF32 products: each element's (hi, lo) pair, the TF32
// bit patterns as floats (valid fp32 values), stored by the loader into a hi
// tile and a lo tile, so no product splits what another product reads.
__device__ __forceinline__ float2 split_pair(float x) {
    uint32_t hi, lo;
    split_tf32(x, hi, lo);
    return make_float2(__uint_as_float(hi), __uint_as_float(lo));
}

// wgmma's K-major operands in fp32 (TF32) are tiles in the 128-byte swizzle
// (hopper.cuh): rows of 32 floats per atom column, the 16-byte chunk c of
// row r at c ^ (r % 8). The byte offset of element (r, c) of such a tile
// whose atom columns hold `rows` rows each:
__device__ __forceinline__ uint32_t sw_tf32(int r, int c, int rows) {
    return (uint32_t)(c >> 5) * (uint32_t)rows * 128u + (uint32_t)r * 128u +
           ((((uint32_t)(c & 31) >> 2) ^ (uint32_t)(r & 7)) << 4) + ((uint32_t)c & 3u) * 4u;
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (src is then
// not read, but must be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the N most recent groups of this thread's copies have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace usk
