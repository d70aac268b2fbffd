// Fused conv-frontend block: y = gelu?( conv1d_{k in {2,3}, s=2}( gelu_in?( x*a + b ) ) ).
//
// Replaces unispeech_tpu/ops/pallas/conv_stack.py::_fwd_kernel (launched by
// _run_fwd), forward only: the pre-activation the TPU kernel also writes is
// a training residual and is not produced here.
//
// Bound on the H100: operations. The block is a GEMM of M = B * t_out rows,
// N = C = 512 output channels and a contraction of k * C over (tap j, input
// channel): output row t reads x[b, 2t + j, :] for j < k, i.e. k*C contiguous
// elements starting at row 2t, so the A operand is the input itself, read
// with a row stride of 2C and no im2col copy. At 4 x 16 s the first block
// alone is 161 GFLOP against a 210 MB input, far above the card's
// ~295 FLOP/byte ridge. Design: bf16 tensor cores through mma.sync.m16n8k16
// (fp32 accumulate), operands loaded from shared memory by ldmatrix, a
// 128 x 128 output tile per block of 8 warps (each 32 x 64, accumulators in
// registers), 32-deep K steps copied by cp.async into a 3-stage ring, one
// barrier per step, so two steps' copies are in flight under the MMAs. The
// prologue (the folded GroupNorm affine in fp32, rounded to bf16, then the
// input GELU, rounded to bf16) is applied in shared memory by the thread that
// copied each chunk, after it lands; the epilogue applies the output GELU in
// fp32 to the accumulators and stores bf16 pairs. Output rows stop at t_out:
// nothing past the returned length is written. GELU is exact erf.

#include "common.cuh"

namespace {

constexpr int kBM = 128;  // output rows per block
constexpr int kBN = 128;  // output channels per block
constexpr int kBK = 32;   // contraction step
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kALd = kBK + 8;  // padded rows (bf16): ldmatrix reads conflict-free
constexpr int kBLd = kBN + 8;
constexpr int kAStage = kBM * kALd;  // elements per stage
constexpr int kBStage = kBK * kBLd;
constexpr size_t kSmemBytes = (size_t)kStages * (kAStage + kBStage) * sizeof(__nv_bfloat16);

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N)); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
// D = A.B + D, A 16x16 row-major bf16, B 16x8 col-major bf16, D fp32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool kAffine, bool kGeluIn, bool kGeluOut>
__global__ void __launch_bounds__(kThreads) conv_gelu_kernel(
    const __nv_bfloat16* __restrict__ x,  // (B, ts, C)
    const __nv_bfloat16* __restrict__ w,  // (k, C, C) == (k*C, C) row-major
    const float* __restrict__ aff_a,      // (B, C) or null
    const float* __restrict__ aff_b,      // (B, C) or null
    __nv_bfloat16* __restrict__ y,        // (B, t_out, C)
    int ts, int t_out, int C, int k) {
    extern __shared__ __align__(128) unsigned char smem[];
    auto* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [kStages][kBM][kALd]
    auto* Bs = As + kStages * kAStage;                 // [kStages][kBK][kBLd]

    const int b = blockIdx.z;
    const int m0 = blockIdx.x * kBM;
    const int n0 = blockIdx.y * kBN;
    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int wm = warp / 2;  // 4 warps along M, 32 rows each
    const int wn = warp % 2;  // 2 warps along N, 64 columns each
    const int nk = k * C / kBK;
    const __nv_bfloat16* xb = x + (size_t)b * ts * C;

    float acc[2][8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

    // each K step copies a 128x32 A tile and a 32x128 B tile: 512 16-byte
    // chunks each, two per thread. A rows past t_out read row t_out - 1
    // (mapped; their outputs are never stored).
    auto copy = [&](int ks) {
        const int k0 = ks * kBK, slot = ks % kStages;
        const int j = k0 / C, ci0 = k0 % C;  // C % kBK == 0: one tap per step
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int ch = tid + i * kThreads;
            const int r = ch >> 2, cc = (ch & 3) * 8;
            const int t = min(m0 + r, t_out - 1);
            cp_async16(As + slot * kAStage + r * kALd + cc,
                       xb + (size_t)(2 * t + j) * C + ci0 + cc);
            const int br = ch >> 4, bc = (ch & 15) * 8;
            cp_async16(Bs + slot * kBStage + br * kBLd + bc,
                       w + (size_t)(k0 + br) * C + n0 + bc);
        }
    };
    // the prologue on the A chunks this thread copied
    auto prologue = [&](int ks) {
        const int ci0 = (ks * kBK) % C, slot = ks % kStages;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int ch = tid + i * kThreads;
            const int r = ch >> 2, cc = (ch & 3) * 8;
            uint4* p = reinterpret_cast<uint4*>(As + slot * kAStage + r * kALd + cc);
            uint4 v = *p;
            __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                float f = usk::bf2f(e[q]);
                if (kAffine) {
                    const int ci = b * C + ci0 + cc + q;
                    // mul then add, each rounded, as the plain version
                    f = usk::round_bf16(__fadd_rn(__fmul_rn(f, aff_a[ci]), aff_b[ci]));
                }
                if (kGeluIn) f = usk::gelu_erf(f);
                e[q] = usk::f2bf(f);
            }
            *p = v;
        }
    };

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < nk) copy(s);
        cp_async_commit();
    }
    for (int ks = 0; ks < nk; ++ks) {
        cp_async_wait<kStages - 2>();  // step ks has landed (this thread's copies)
        if (kAffine || kGeluIn) prologue(ks);
        __syncthreads();  // ks visible to all; every warp is done with step ks-1
        if (ks + kStages - 1 < nk) copy(ks + kStages - 1);  // into step ks-1's slot
        cp_async_commit();

        const __nv_bfloat16* At = As + (ks % kStages) * kAStage;
        const __nv_bfloat16* Bt = Bs + (ks % kStages) * kBStage;
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16) {
            uint32_t af[2][4];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                ldmatrix_x4(af[i], At + (wm * 32 + i * 16 + (lane & 15)) * kALd + kk + (lane >> 4) * 8);
#pragma unroll
            for (int jp = 0; jp < 4; ++jp) {
                uint32_t bf[4];
                ldmatrix_x4_trans(bf, Bt + (kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * kBLd
                                          + wn * 64 + jp * 16 + 8 * (lane >> 4));
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    mma_bf16(acc[i][2 * jp], af[i], bf[0], bf[1]);
                    mma_bf16(acc[i][2 * jp + 1], af[i], bf[2], bf[3]);
                }
            }
        }
    }

    // epilogue from the accumulators: rows g / g+8, columns c2, c2+1 of each
    // 8-wide n-tile
    const int g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int t = m0 + wm * 32 + i * 16 + g + 8 * e;
            if (t >= t_out) continue;
            __nv_bfloat16* yr = y + ((size_t)b * t_out + t) * C + n0 + wn * 64 + c2;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                float v0 = acc[i][j][2 * e], v1 = acc[i][j][2 * e + 1];
                if (kGeluOut) {
                    v0 = usk::gelu_erf(v0);
                    v1 = usk::gelu_erf(v1);
                }
                *reinterpret_cast<__nv_bfloat162*>(yr + j * 8) = __floats2bfloat162_rn(v0, v1);
            }
        }
    }
}

template <bool kAffine, bool kGeluIn, bool kGeluOut>
cudaError_t launch(const void* x, const void* w, const void* a, const void* bb, void* y,
                   int B, int ts, int t_out, int C, int k, cudaStream_t stream) {
    auto kernel = conv_gelu_kernel<kAffine, kGeluIn, kGeluOut>;
    // above 48 KB of dynamic shared memory only after opting in (per device)
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((t_out + kBM - 1) / kBM, C / kBN, B);
    kernel<<<grid, kThreads, kSmemBytes, stream>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const float*)a,
        (const float*)bb, (__nv_bfloat16*)y, ts, t_out, C, k);
    return cudaGetLastError();
}

}  // namespace

extern "C" int usk_conv_gelu_block(const void* x, const void* w, const void* a,
                                   const void* b, void* y, int B, int ts,
                                   int t_out, int C, int k, int gelu_in,
                                   int gelu_out, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    const int sel = (a != nullptr ? 4 : 0) | (gelu_in ? 2 : 0) | (gelu_out ? 1 : 0);
    switch (sel) {
        case 0: return (int)launch<false, false, false>(x, w, a, b, y, B, ts, t_out, C, k, s);
        case 1: return (int)launch<false, false, true>(x, w, a, b, y, B, ts, t_out, C, k, s);
        case 2: return (int)launch<false, true, false>(x, w, a, b, y, B, ts, t_out, C, k, s);
        case 3: return (int)launch<false, true, true>(x, w, a, b, y, B, ts, t_out, C, k, s);
        case 4: return (int)launch<true, false, false>(x, w, a, b, y, B, ts, t_out, C, k, s);
        case 5: return (int)launch<true, false, true>(x, w, a, b, y, B, ts, t_out, C, k, s);
        case 6: return (int)launch<true, true, false>(x, w, a, b, y, B, ts, t_out, C, k, s);
        default: return (int)launch<true, true, true>(x, w, a, b, y, B, ts, t_out, C, k, s);
    }
}
