// Fused attention forward with WavLM's gated relative position bias.
//
// Replaces unispeech_tpu/ops/pallas/flash_attention.py::_fwd_kernel
// (head-major layout, launched by _run_forward) and ::_fwd_kernel_packed
// (natural (B, T, H*hd) layout, launched by _run_forward_packed):
//   out = dropout(softmax(q*scale . k^T + gate[b,h,t] * bias[h,t,s]
//                 + attn_mask[t,s] - 1e30 * (key s padded or s >= S))) . v
// and, when asked, lse = max + log(sum) per query row (taken before
// dropout). Neither the logits nor the probabilities reach device memory.
//
// Bound on the H100: bytes. At WavLM-Base+ width and 4 x 16 s one call does
// 7.85 GFLOP (8 us at the bf16 tensor-core peak) but must read q, k, v and
// the (H, T, S) bf16 bias and write out, about 35 MB (10 us at 3.35 TB/s).
// Design: one block of 4 warps per (64-query tile, head, utterance); q, k, v
// and out are addressed by strides straight in the (B, T, H*hd) projection
// layout, so the TPU's two layouts collapse into one kernel and no transpose
// runs. Keys stream in 64-row tiles through shared memory, double-buffered:
// the next tile's K/V are copied by cp.async (zero-filled past S) while the
// current one is used. With each key tile the block stages the gated bias (gate * bias + attn_mask) of its
// 64 x 64 (query, key) tile in shared memory with coalesced loads, all of a
// thread's loads issued before its first store, so the bias costs about one
// memory latency per tile. Each warp owns 16 query rows and keeps its
// scores, probabilities and output in registers in the layout of the bf16
// tensor-core instruction mma.sync.m16n8k16 (fp32 accumulate): S = q.k^T,
// the online softmax (running max and sum in fp32), P rounded to bf16 and
// fed back as the A operand of P.V without leaving registers (V fragments
// by ldmatrix.trans). Ragged T and S are masked in the kernel: key rows past
// S are zero-filled and -1e30'd, query rows past T are not stored.
//
// Dropout (training): the un-normalised P is multiplied by keep/(1 - rate)
// after its row sum is taken, as the TPU kernel does. The keep bit of each
// (b, h, t, s) comes from Philox-4x32-10 keyed by the 64-bit seed, which is
// read from device memory (no host sync to draw it), counted by the
// absolute coordinates (philox.cuh), so the backward kernel and the plain
// version regenerate the identical mask. One Philox call serves a 2 x 2
// (t, s) block; a thread uses two of its words.

#include <math.h>

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kHd = 64;    // head dim
constexpr int kBQ = 64;    // queries per block
constexpr int kBKey = 64;  // keys per step
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kLd = kHd + 8;     // bf16 row of the Q/K/V tiles: 144 B, conflict-free
constexpr int kALd = kBKey + 8;  // fp32 row of the staged bias tile
constexpr float kNegInf = -1e30f;

constexpr size_t kTileBytes = kBKey * kLd * sizeof(__nv_bfloat16);
constexpr size_t kOffK = kTileBytes;  // Q tile first, then K/V of two stages
constexpr size_t kOffV = kOffK + 2 * kTileBytes;
constexpr size_t kOffA = kOffV + 2 * kTileBytes;  // staged gate * bias + attn_mask
constexpr size_t kOffCol = kOffA + kBQ * kALd * sizeof(float);  // key mask of the tile
constexpr size_t kOffGate = kOffCol + kBKey * sizeof(float);
constexpr size_t kSmemBytes = kOffGate + kBQ * sizeof(float);
constexpr int kStageRows = kThreads / kBKey;  // tile rows one staging pass covers

struct Args {
    const __nv_bfloat16* q;
    const __nv_bfloat16* k;
    const __nv_bfloat16* v;
    __nv_bfloat16* out;
    long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs;  // elements
    const __nv_bfloat16* bias;  // (H, T, S) or null
    const float* gate;          // (B, H, T) or null (gate 1 with bias)
    const uint8_t* kpm;         // (B, S) 1 = padded key, or null
    const float* amask;         // (T, S) or null
    float* lse;                 // (B, H, T) or null
    const long long* seed;      // dropout seed (1 element) or null: no dropout
    unsigned threshold;         // keep iff the Philox word >= threshold
    float drop_scale;           // 1 / (1 - rate)
    int T, S, H;
    float scale;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
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

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem_row) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// 16-byte global -> shared copy that bypasses registers; zero-fills when
// !valid (the source address must still be mapped)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N)); }

__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Args a) {
    extern __shared__ __align__(128) unsigned char smem[];
    auto* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
    auto* Ks = reinterpret_cast<__nv_bfloat16*>(smem + kOffK);
    auto* Vs = reinterpret_cast<__nv_bfloat16*>(smem + kOffV);
    auto* As = reinterpret_cast<float*>(smem + kOffA);
    auto* colneg = reinterpret_cast<float*>(smem + kOffCol);
    auto* Gs = reinterpret_cast<float*>(smem + kOffGate);

    const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int T = a.T, S = a.S, H = a.H;
    const bool has_add = a.bias != nullptr || a.amask != nullptr;
    const bool dropout = a.seed != nullptr;
    const uint64_t seed = dropout ? (uint64_t)*a.seed : 0;

    // q tile, scaled in its own dtype (bf16(q * scale), as the reference
    // pre-scales q before the kernel), and the tile's gates
    for (int ch = tid; ch < kBQ * kHd / 8; ch += kThreads) {
        const int r = ch / (kHd / 8), c8 = (ch % (kHd / 8)) * 8;
        const int t = q0 + r;
        uint4 v4 = make_uint4(0, 0, 0, 0);
        if (t < T) {
            v4 = *reinterpret_cast<const uint4*>(a.q + b * a.q_bs + t * a.q_rs + h * kHd + c8);
            __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v4);
#pragma unroll
            for (int i = 0; i < 8; ++i) e[i] = usk::f2bf(usk::bf2f(e[i]) * a.scale);
        }
        *reinterpret_cast<uint4*>(Qs + r * kLd + c8) = v4;
    }
    for (int r = tid; r < kBQ; r += kThreads) {
        const int t = q0 + r;
        Gs[r] = (a.gate != nullptr && t < T) ? a.gate[((size_t)b * H + h) * T + t] : 1.f;
    }
    __syncthreads();

    // mma fragment coordinates: g = row group, c = column pair
    const int g = lane >> 2, c2 = (lane & 3) * 2;
    const int row0 = warp * 16 + g;  // rows row0 and row0 + 8 of the block tile
    uint32_t qa[kHd / 16][4];
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk) {
        const __nv_bfloat16* q_lo = Qs + row0 * kLd + kk * 16 + c2;
        const __nv_bfloat16* q_hi = q_lo + 8 * kLd;
        qa[kk][0] = lds32(q_lo);
        qa[kk][1] = lds32(q_hi);
        qa[kk][2] = lds32(q_lo + 8);
        qa[kk][3] = lds32(q_hi + 8);
    }

    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float o[kHd / 8][4];
#pragma unroll
    for (int j = 0; j < kHd / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

    // K/V tile copies: key row s of the tile (clamped to a mapped row, then
    // zero-filled past S) into stage st
    auto copy_kv = [&](int s0, int st) {
#pragma unroll
        for (int i = 0; i < kBKey * kHd / 8 / kThreads; ++i) {
            const int ch = tid + i * kThreads;
            const int kr = ch / (kHd / 8), c8 = (ch % (kHd / 8)) * 8;
            const int s = min(s0 + kr, S - 1);
            cp_async16(Ks + (st * kBKey + kr) * kLd + c8,
                       a.k + b * a.k_bs + s * a.k_rs + h * kHd + c8, s0 + kr < S);
            cp_async16(Vs + (st * kBKey + kr) * kLd + c8,
                       a.v + b * a.v_bs + s * a.v_rs + h * kHd + c8, s0 + kr < S);
        }
        cp_async_commit();
    };

    // staging coordinates: thread -> column sc, rows sr, sr + kStageRows, ...
    const int sc = tid % kBKey, sr = tid / kBKey;
    constexpr int kN = kBQ / kStageRows;
    // an additive (T, S) term of the tile into As: every load is issued (from
    // a clamped, mapped address) before the first store, so they overlap
    auto stage_add = [&](int s0, const auto* src, bool accumulate) {
        const int ss = s0 + sc;
        const int ssc = min(ss, S - 1);
        float vals[kN];
#pragma unroll
        for (int j = 0; j < kN; ++j) {
            const int tt = min(q0 + sr + j * kStageRows, T - 1);
            vals[j] = static_cast<float>(src[(size_t)tt * S + ssc]);
        }
#pragma unroll
        for (int j = 0; j < kN; ++j) {
            const int rr = sr + j * kStageRows;
            const float v = (q0 + rr < T && ss < S) ? vals[j] : 0.f;
            if (accumulate) As[rr * kALd + sc] += v;
            else As[rr * kALd + sc] = Gs[rr] * v;
        }
    };

    copy_kv(0, 0);
    const int n_tiles = (S + kBKey - 1) / kBKey;
    for (int it = 0; it < n_tiles; ++it) {
        const int s0 = it * kBKey, st = it & 1;
        __syncthreads();  // every warp is done with the previous tile
        if (it + 1 < n_tiles) copy_kv(s0 + kBKey, st ^ 1);
        if (tid < kBKey) {
            const int s = s0 + tid;
            colneg[tid] = (s >= S || (a.kpm != nullptr && a.kpm[(size_t)b * S + s]))
                              ? kNegInf : 0.f;
        }
        if (has_add) {
            if (a.bias != nullptr) {
                stage_add(s0, a.bias + (size_t)h * T * S, false);
            } else {
#pragma unroll
                for (int j = 0; j < kN; ++j) As[(sr + j * kStageRows) * kALd + sc] = 0.f;
            }
            if (a.amask != nullptr) stage_add(s0, a.amask, true);
        }
        if (it + 1 < n_tiles) cp_async_wait<1>();
        else cp_async_wait<0>();
        __syncthreads();
        const __nv_bfloat16* Kt = Ks + st * kBKey * kLd;
        const __nv_bfloat16* Vt = Vs + st * kBKey * kLd;

        // S = q.k^T: 8 n-tiles of 8 keys, in the accumulator layout
        // (rows g / g+8, columns c2, c2+1 of each n-tile)
        float sacc[kBKey / 8][4];
#pragma unroll
        for (int j = 0; j < kBKey / 8; ++j) {
            sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
            const __nv_bfloat16* krow = Kt + (j * 8 + g) * kLd + c2;
#pragma unroll
            for (int kk = 0; kk < kHd / 16; ++kk)
                mma_bf16(sacc[j], qa[kk], lds32(krow + kk * 16), lds32(krow + kk * 16 + 8));
        }

        // gated bias, masks, online softmax; rows row0 (e=0) and row0 + 8 (e=1)
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < kBKey / 8; ++j) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int e = i >> 1, col = j * 8 + c2 + (i & 1);
                float x = sacc[j][i];
                if (has_add) x += As[(row0 + 8 * e) * kALd + col];
                x += colneg[col];
                sacc[j][i] = x;
                mx[e] = fmaxf(mx[e], x);
            }
        }
        float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
            mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
            const float m_new = fmaxf(m[e], mx[e]);
            alpha[e] = expf(m[e] - m_new);
            m[e] = m_new;
        }
#pragma unroll
        for (int j = 0; j < kBKey / 8; ++j) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int e = i >> 1;
                const float p = expf(sacc[j][i] - m[e]);
                rs[e] += p;
                sacc[j][i] = p;
            }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            rs[e] += __shfl_xor_sync(0xffffffffu, rs[e], 1);
            rs[e] += __shfl_xor_sync(0xffffffffu, rs[e], 2);
            l[e] = l[e] * alpha[e] + rs[e];
        }
        if (dropout) {  // after the row sums: l is the undropped normaliser
#pragma unroll
            for (int j = 0; j < kBKey / 8; ++j) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    bool k0, k1;
                    usk::attention_keep_pair(seed, a.threshold, b, h, q0 + row0 + 8 * e,
                                             s0 + j * 8 + c2, k0, k1);
                    sacc[j][2 * e] *= k0 ? a.drop_scale : 0.f;
                    sacc[j][2 * e + 1] *= k1 ? a.drop_scale : 0.f;
                }
            }
        }
#pragma unroll
        for (int j = 0; j < kHd / 8; ++j) {
            o[j][0] *= alpha[0];
            o[j][1] *= alpha[0];
            o[j][2] *= alpha[1];
            o[j][3] *= alpha[1];
        }

        // O += P.V: P (bf16) from the score registers as A fragments of 16
        // keys; V fragments of (16 keys x 16 dims) by one ldmatrix.x4.trans
#pragma unroll
        for (int kk = 0; kk < kBKey / 16; ++kk) {
            const uint32_t pa[4] = {
                pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]),
                pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
                pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
                pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3]),
            };
            const int mat = lane >> 3;  // which 8x8 matrix this lane addresses
            const __nv_bfloat16* vrow =
                Vt + (kk * 16 + (lane & 7) + 8 * (mat & 1)) * kLd + 8 * (mat >> 1);
#pragma unroll
            for (int jp = 0; jp < kHd / 16; ++jp) {
                uint32_t vb[4];
                ldmatrix_x4_trans(vb, vrow + jp * 16);
                mma_bf16(o[2 * jp], pa, vb[0], vb[1]);
                mma_bf16(o[2 * jp + 1], pa, vb[2], vb[3]);
            }
        }
    }

    // normalize and store: rows row0 / row0 + 8, columns j*8 + c2, +1
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        const int t = q0 + row0 + 8 * e;
        if (t >= T) continue;
        __nv_bfloat16* dst = a.out + b * a.o_bs + t * a.o_rs + h * kHd + c2;
#pragma unroll
        for (int j = 0; j < kHd / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
                __floats2bfloat162_rn(o[j][2 * e] / l[e], o[j][2 * e + 1] / l[e]);
        if (a.lse != nullptr && c2 == 0) a.lse[((size_t)b * H + h) * T + t] = m[e] + logf(l[e]);
    }
}

}  // namespace

extern "C" int usk_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out,
    long long q_bs, long long q_rs, long long k_bs, long long k_rs,
    long long v_bs, long long v_rs, long long o_bs, long long o_rs,
    const void* bias, const void* gate, const void* kpm, const void* amask,
    void* lse, int B, int T, int S, int H, float scale, const void* seed,
    unsigned threshold, float drop_scale, void* stream) {
    // above 48 KB of dynamic shared memory only after opting in (per device)
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    Args a;
    a.q = (const __nv_bfloat16*)q;
    a.k = (const __nv_bfloat16*)k;
    a.v = (const __nv_bfloat16*)v;
    a.out = (__nv_bfloat16*)out;
    a.q_bs = q_bs; a.q_rs = q_rs; a.k_bs = k_bs; a.k_rs = k_rs;
    a.v_bs = v_bs; a.v_rs = v_rs; a.o_bs = o_bs; a.o_rs = o_rs;
    a.bias = (const __nv_bfloat16*)bias;
    a.gate = (const float*)gate;
    a.kpm = (const uint8_t*)kpm;
    a.amask = (const float*)amask;
    a.lse = (float*)lse;
    a.seed = (const long long*)seed;
    a.threshold = threshold;
    a.drop_scale = drop_scale;
    a.T = T; a.S = S; a.H = H;
    a.scale = scale;
    const dim3 grid((T + kBQ - 1) / kBQ, H, B);
    flash_fwd_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
