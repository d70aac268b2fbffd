// Fused attention backward (merged: dq, dk, dv, dgate, dbias in one pass).
//
// Replaces unispeech_tpu/ops/pallas/flash_attention.py::_bwd_kernel
// (head-major layout, launched by _run_backward) and ::_bwd_kernel_packed
// (natural layout, launched by _run_backward_packed). With q^ = bf16(q *
// scale) and p = exp(s - lse) recomputed from the forward's inputs and lse,
// c = keep / (1 - rate) regenerated from the seed (philox.cuh), and
// delta = rowsum(dO * out):
//   dP = dO . v^T,  dS = p * (c * dP - delta)
//   dq^ = dS . k,  dk = dS^T . q^,  dv = (p * c)^T . dO
//   dgate[b,h,t] = sum_s dS * bias,  dbias[h,t,s] = sum_b gate * dS
// dS and p * c are rounded to bf16 as matrix-product operands, as the TPU
// kernel does; dgate and dbias use the fp32 dS.
//
// Bound on the H100: operations. At the WavLM-Base pretraining shape
// (6 x 768 frames, 12 heads) one call does 5 products of 2*B*H*T*S*64 =
// 21.7 GFLOP (22 us at the bf16 tensor-core peak) against ~30 MB of inputs
// and outputs (9 us at 3.35 TB/s), plus one exp and, with dropout, half a
// Philox call per (t, s).
// Design: one block of 4 warps per (64-key tile, head, utterance), looping
// over 64-query tiles. Each warp owns 16 keys: S^T = K.q^T and dP^T = V.dO^T
// land in mma.sync.m16n8k16 accumulators (keys x queries), dK and dV stay in
// registers for the whole loop and are written once in bf16 (no atomics).
// (P*c)^T and dS^T feed dV and dK straight from the accumulator registers
// (bf16 A fragments); dS goes through shared memory once more for
// dq^ = dS.K, each warp then owning 16 queries. Three sums cross blocks:
//  - dq^ sums over key tiles: fp32 atomics into a zeroed (B, T, H, 64)
//    buffer; the wrapper rounds it to bf16 and applies the chain rule of
//    q * scale.
//  - dgate sums over key tiles: reduced within the block (warp shuffles,
//    shared-memory atomics), then one fp32 atomic per query and block.
//  - dbias sums over the batch: gate * dS is staged in shared memory and
//    added to a zeroed fp32 (H, T, S) buffer by coalesced fp32 atomics; the
//    wrapper casts it to the bias dtype.
// The order of these fp32 atomic additions varies from run to run, so dq,
// dgate and dbias agree with the plain version to fp32 rounding of a sum of
// (S/64, S/64, B) terms, below one bf16 ulp of the outputs.
// delta comes from a small pre-pass (delta_kernel), one 8-lane group per
// (b, t, h) row.

#include <math.h>

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kHd = 64;     // head dim
constexpr int kBKey = 64;   // keys per block
constexpr int kBQ = 64;     // queries per step
constexpr int kThreads = 128;
constexpr int kLd = kHd + 8;     // bf16 rows of 144 B: ldmatrix reads conflict-free
constexpr int kFLd = kBKey + 4;  // fp32 rows
constexpr float kNegInf = -1e30f;

constexpr size_t kTile = (size_t)kBKey * kLd * sizeof(__nv_bfloat16);
constexpr size_t kOffV = kTile;          // K, V, q^, dO, bias, dS tiles (bf16)
constexpr size_t kOffQ = 2 * kTile;
constexpr size_t kOffD = 3 * kTile;
constexpr size_t kOffB = 4 * kTile;
constexpr size_t kOffS = 5 * kTile;
constexpr size_t kOffA = 6 * kTile;      // attn_mask tile (fp32)
constexpr size_t kOffG = kOffA + (size_t)kBQ * kFLd * sizeof(float);  // gate * dS (fp32)
constexpr size_t kOffRow = kOffG + (size_t)kBQ * kFLd * sizeof(float);  // per-query rows
constexpr size_t kSmemBytes = kOffRow + (4 * kBQ + kBKey) * sizeof(float);

struct Args {
    const __nv_bfloat16 *q, *k, *v, *out, *dout;
    const float* lse;  // (B, H, T)
    long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, do_bs, do_rs;  // elements
    const __nv_bfloat16* bias;  // (H, T, S) or null
    const float* gate;          // (B, H, T) or null (gate 1 with bias)
    const uint8_t* kpm;         // (B, S) 1 = padded key, or null
    const float* amask;         // (T, S) or null
    float* dq;                  // (B, T, H, 64) fp32, zeroed: dq^ = dS . k
    __nv_bfloat16* dk;          // (B, S, H, 64)
    __nv_bfloat16* dv;          // (B, S, H, 64)
    float* dgate;               // (B, H, T) zeroed, or null
    float* dbias;               // (H, T, S) fp32 zeroed, or null
    float* delta;               // (B, H, T), written by delta_kernel
    const long long* seed;      // dropout seed or null
    unsigned threshold;
    float drop_scale;
    int T, S, H;
    float scale;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// delta[b, h, t] = sum_d dO[b, t, h, d] * out[b, t, h, d]: 8 lanes per row
__global__ void __launch_bounds__(256) delta_kernel(const Args a, int rows) {
    const int r = blockIdx.x * 32 + threadIdx.x / 8;
    const int part = threadIdx.x % 8;
    float acc = 0.f;
    int b = 0, t = 0, h = 0;
    if (r < rows) {
        b = r / (a.T * a.H);
        t = (r / a.H) % a.T;
        h = r % a.H;
        const uint4 o4 = *reinterpret_cast<const uint4*>(
            a.out + b * a.o_bs + t * a.o_rs + h * kHd + part * 8);
        const uint4 d4 = *reinterpret_cast<const uint4*>(
            a.dout + b * a.do_bs + t * a.do_rs + h * kHd + part * 8);
        const __nv_bfloat16* o = reinterpret_cast<const __nv_bfloat16*>(&o4);
        const __nv_bfloat16* d = reinterpret_cast<const __nv_bfloat16*>(&d4);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc = fmaf(usk::bf2f(d[i]), usk::bf2f(o[i]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    acc += __shfl_xor_sync(0xffffffffu, acc, 4);
    if (r < rows && part == 0) a.delta[((size_t)b * a.H + h) * a.T + t] = acc;
}

__global__ void __launch_bounds__(kThreads) flash_bwd_kernel(const Args a) {
    extern __shared__ __align__(128) unsigned char smem[];
    auto* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
    auto* Vs = reinterpret_cast<__nv_bfloat16*>(smem + kOffV);
    auto* Qs = reinterpret_cast<__nv_bfloat16*>(smem + kOffQ);
    auto* Ds = reinterpret_cast<__nv_bfloat16*>(smem + kOffD);
    auto* Bs = reinterpret_cast<__nv_bfloat16*>(smem + kOffB);
    auto* dSs = reinterpret_cast<__nv_bfloat16*>(smem + kOffS);
    auto* Am = reinterpret_cast<float*>(smem + kOffA);
    auto* Gd = reinterpret_cast<float*>(smem + kOffG);
    auto* lse_s = reinterpret_cast<float*>(smem + kOffRow);
    float* delta_s = lse_s + kBQ;
    float* gate_s = delta_s + kBQ;
    float* dgate_s = gate_s + kBQ;
    float* colneg = dgate_s + kBQ;

    const int s0 = blockIdx.x * kBKey, h = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int T = a.T, S = a.S, H = a.H;
    const bool has_bias = a.bias != nullptr;
    const bool dropout = a.seed != nullptr;
    const uint64_t seed = dropout ? (uint64_t)*a.seed : 0;
    const int g = lane >> 2, c2 = (lane & 3) * 2;
    const int key0 = warp * 16;  // this warp's key rows of the tile (S^T phase)
    const int mat = lane >> 3;   // which 8x8 matrix this lane addresses in ldmatrix

    // the block's K and V tiles, zero past S; the key mask
    for (int ch = tid; ch < kBKey * kHd / 8; ch += kThreads) {
        const int r = ch / (kHd / 8), c8 = (ch % (kHd / 8)) * 8;
        const int s = s0 + r;
        uint4 k4 = make_uint4(0, 0, 0, 0), v4 = make_uint4(0, 0, 0, 0);
        if (s < S) {
            k4 = *reinterpret_cast<const uint4*>(a.k + b * a.k_bs + s * a.k_rs + h * kHd + c8);
            v4 = *reinterpret_cast<const uint4*>(a.v + b * a.v_bs + s * a.v_rs + h * kHd + c8);
        }
        *reinterpret_cast<uint4*>(Ks + r * kLd + c8) = k4;
        *reinterpret_cast<uint4*>(Vs + r * kLd + c8) = v4;
    }
    if (tid < kBKey) {
        const int s = s0 + tid;
        colneg[tid] = (s >= S || (a.kpm != nullptr && a.kpm[(size_t)b * S + s])) ? kNegInf : 0.f;
    }

    float dk[kHd / 8][4], dv[kHd / 8][4];
#pragma unroll
    for (int j = 0; j < kHd / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) dk[j][i] = dv[j][i] = 0.f;

    const int n_qt = (T + kBQ - 1) / kBQ;
    for (int qt = 0; qt < n_qt; ++qt) {
        const int q0 = qt * kBQ;
        __syncthreads();  // every warp is done with the previous query tile
        for (int ch = tid; ch < kBQ * kHd / 8; ch += kThreads) {
            const int r = ch / (kHd / 8), c8 = (ch % (kHd / 8)) * 8;
            const int t = q0 + r;
            uint4 q4 = make_uint4(0, 0, 0, 0), d4 = make_uint4(0, 0, 0, 0);
            if (t < T) {
                q4 = *reinterpret_cast<const uint4*>(a.q + b * a.q_bs + t * a.q_rs + h * kHd + c8);
                __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&q4);
#pragma unroll
                for (int i = 0; i < 8; ++i) e[i] = usk::f2bf(usk::bf2f(e[i]) * a.scale);
                d4 = *reinterpret_cast<const uint4*>(
                    a.dout + b * a.do_bs + t * a.do_rs + h * kHd + c8);
            }
            *reinterpret_cast<uint4*>(Qs + r * kLd + c8) = q4;
            *reinterpret_cast<uint4*>(Ds + r * kLd + c8) = d4;
        }
        if (tid < kBQ) {
            const int t = q0 + tid;
            const bool ok = t < T;
            const size_t row = ((size_t)b * H + h) * T + t;
            lse_s[tid] = ok ? a.lse[row] : INFINITY;  // p = 0 on rows past T
            delta_s[tid] = ok ? a.delta[row] : 0.f;
            gate_s[tid] = (ok && a.gate != nullptr) ? a.gate[row] : 1.f;
            dgate_s[tid] = 0.f;
        }
        if (has_bias) {
            for (int idx = tid; idx < kBQ * kBKey; idx += kThreads) {
                const int r = idx / kBKey, c = idx % kBKey;
                const int t = q0 + r, s = s0 + c;
                Bs[r * kLd + c] = (t < T && s < S) ? a.bias[((size_t)h * T + t) * S + s]
                                                   : usk::f2bf(0.f);
            }
        }
        if (a.amask != nullptr) {
            for (int idx = tid; idx < kBQ * kBKey; idx += kThreads) {
                const int r = idx / kBKey, c = idx % kBKey;
                const int t = q0 + r, s = s0 + c;
                Am[r * kFLd + c] = (t < T && s < S) ? a.amask[(size_t)t * S + s] : 0.f;
            }
        }
        __syncthreads();

        // S^T = K.q^T and dP^T = V.dO^T: this warp's 16 keys x 64 queries,
        // 8 n-tiles of 8 queries (rows g / g+8, columns c2, c2+1 of each)
        float st[kBQ / 8][4], dpt[kBQ / 8][4];
#pragma unroll
        for (int j = 0; j < kBQ / 8; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) st[j][i] = dpt[j][i] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kHd / 16; ++kk) {
            uint32_t ka[4], va[4];
            ldmatrix_x4(ka, Ks + (key0 + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8);
            ldmatrix_x4(va, Vs + (key0 + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int jp = 0; jp < kBQ / 16; ++jp) {
                // B[k = hd][n = query] from rows n of q^ / dO: non-transposed
                const int off = (jp * 16 + (mat >> 1) * 8 + (lane & 7)) * kLd + kk * 16 +
                                (mat & 1) * 8;
                uint32_t qb[4], db[4];
                ldmatrix_x4(qb, Qs + off);
                ldmatrix_x4(db, Ds + off);
                mma_bf16(st[2 * jp], ka, qb[0], qb[1]);
                mma_bf16(st[2 * jp + 1], ka, qb[2], qb[3]);
                mma_bf16(dpt[2 * jp], va, db[0], db[1]);
                mma_bf16(dpt[2 * jp + 1], va, db[2], db[3]);
            }
        }

        // p, p*c (into st) and dS (into dpt); dS and gate*dS to shared memory
        float dgq[kBQ / 8][2];
#pragma unroll
        for (int j = 0; j < kBQ / 8; ++j) {
            dgq[j][0] = dgq[j][1] = 0.f;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int kr = key0 + g + 8 * e;  // key row in the tile
                const int qc = j * 8 + c2;        // first of the query pair
                bool keep0 = true, keep1 = true;
                if (dropout)
                    usk::attention_keep_colpair(seed, a.threshold, b, h, q0 + qc, s0 + kr,
                                                keep0, keep1);
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const int qr = qc + i;
                    float x = st[j][2 * e + i];
                    float braw = 0.f;
                    if (has_bias) {
                        braw = usk::bf2f(Bs[qr * kLd + kr]);
                        x += gate_s[qr] * braw;
                    }
                    if (a.amask != nullptr) x += Am[qr * kFLd + kr];
                    x += colneg[kr];
                    const float p = expf(x - lse_s[qr]);
                    const float c = dropout ? ((i ? keep1 : keep0) ? a.drop_scale : 0.f) : 1.f;
                    const float ds = p * (c * dpt[j][2 * e + i] - delta_s[qr]);
                    st[j][2 * e + i] = p * c;
                    dpt[j][2 * e + i] = ds;
                    dgq[j][i] += ds * braw;
                    dSs[qr * kLd + kr] = usk::f2bf(ds);
                    if (has_bias) Gd[qr * kFLd + kr] = gate_s[qr] * ds;
                }
            }
        }
        if (a.dgate != nullptr) {
#pragma unroll
            for (int j = 0; j < kBQ / 8; ++j) {
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    float v = dgq[j][i];
                    v += __shfl_xor_sync(0xffffffffu, v, 4);
                    v += __shfl_xor_sync(0xffffffffu, v, 8);
                    v += __shfl_xor_sync(0xffffffffu, v, 16);
                    if (g == 0) atomicAdd(&dgate_s[j * 8 + c2 + i], v);
                }
            }
        }

        // dV += (p*c)^T . dO and dK += dS^T . q^: A fragments straight from
        // the accumulators (16 keys x 16 queries), B by ldmatrix.trans
#pragma unroll
        for (int kk = 0; kk < kBQ / 16; ++kk) {
            const uint32_t pa[4] = {
                pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]),
            };
            const uint32_t sa[4] = {
                pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
                pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
                pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]),
            };
            const int off = (kk * 16 + (lane & 7) + 8 * (mat & 1)) * kLd + 8 * (mat >> 1);
#pragma unroll
            for (int jp = 0; jp < kHd / 16; ++jp) {
                uint32_t ob[4];
                ldmatrix_x4_trans(ob, Ds + off + jp * 16);
                mma_bf16(dv[2 * jp], pa, ob[0], ob[1]);
                mma_bf16(dv[2 * jp + 1], pa, ob[2], ob[3]);
                ldmatrix_x4_trans(ob, Qs + off + jp * 16);
                mma_bf16(dk[2 * jp], sa, ob[0], ob[1]);
                mma_bf16(dk[2 * jp + 1], sa, ob[2], ob[3]);
            }
        }
        __syncthreads();  // dS, gate*dS and the dgate partials are complete

        // dq^ rows of this warp (16 queries x 64 dims) = dS . K over the tile's keys
        {
            float dq[kHd / 8][4];
#pragma unroll
            for (int j = 0; j < kHd / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
#pragma unroll
            for (int kk = 0; kk < kBKey / 16; ++kk) {
                uint32_t sa[4];
                ldmatrix_x4(sa, dSs + (warp * 16 + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8);
                const int off = (kk * 16 + (lane & 7) + 8 * (mat & 1)) * kLd + 8 * (mat >> 1);
#pragma unroll
                for (int jp = 0; jp < kHd / 16; ++jp) {
                    uint32_t kb[4];
                    ldmatrix_x4_trans(kb, Ks + off + jp * 16);
                    mma_bf16(dq[2 * jp], sa, kb[0], kb[1]);
                    mma_bf16(dq[2 * jp + 1], sa, kb[2], kb[3]);
                }
            }
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int t = q0 + warp * 16 + g + 8 * e;
                if (t >= T) continue;
                float* dst = a.dq + ((size_t)((size_t)b * T + t) * H + h) * kHd + c2;
#pragma unroll
                for (int j = 0; j < kHd / 8; ++j) {
                    atomicAdd(dst + j * 8, dq[j][2 * e]);
                    atomicAdd(dst + j * 8 + 1, dq[j][2 * e + 1]);
                }
            }
        }
        if (a.dgate != nullptr && tid < kBQ && q0 + tid < T)
            atomicAdd(a.dgate + ((size_t)b * H + h) * T + q0 + tid, dgate_s[tid]);
        if (a.dbias != nullptr) {
            for (int idx = tid; idx < kBQ * kBKey; idx += kThreads) {
                const int r = idx / kBKey, c = idx % kBKey;
                const int t = q0 + r, s = s0 + c;
                if (t < T && s < S) atomicAdd(a.dbias + ((size_t)h * T + t) * S + s, Gd[r * kFLd + c]);
            }
        }
    }

    // dK, dV of this warp's keys: rows g / g+8, columns c2, c2+1 of each n-tile
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        const int s = s0 + key0 + g + 8 * e;
        if (s >= S) continue;
        const size_t base = ((size_t)((size_t)b * S + s) * H + h) * kHd + c2;
#pragma unroll
        for (int j = 0; j < kHd / 8; ++j) {
            *reinterpret_cast<__nv_bfloat162*>(a.dk + base + j * 8) =
                __floats2bfloat162_rn(dk[j][2 * e], dk[j][2 * e + 1]);
            *reinterpret_cast<__nv_bfloat162*>(a.dv + base + j * 8) =
                __floats2bfloat162_rn(dv[j][2 * e], dv[j][2 * e + 1]);
        }
    }
}

}  // namespace

extern "C" int usk_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out, const void* dout,
    const void* lse, long long q_bs, long long q_rs, long long k_bs, long long k_rs,
    long long v_bs, long long v_rs, long long o_bs, long long o_rs, long long do_bs,
    long long do_rs, const void* bias, const void* gate, const void* kpm, const void* amask,
    void* dq, void* dk, void* dv, void* dgate, void* dbias, int B, int T, int S, int H,
    float scale, void* delta, unsigned threshold, float drop_scale, const void* seed,
    void* stream) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    Args a;
    a.q = (const __nv_bfloat16*)q;
    a.k = (const __nv_bfloat16*)k;
    a.v = (const __nv_bfloat16*)v;
    a.out = (const __nv_bfloat16*)out;
    a.dout = (const __nv_bfloat16*)dout;
    a.lse = (const float*)lse;
    a.q_bs = q_bs; a.q_rs = q_rs; a.k_bs = k_bs; a.k_rs = k_rs; a.v_bs = v_bs; a.v_rs = v_rs;
    a.o_bs = o_bs; a.o_rs = o_rs; a.do_bs = do_bs; a.do_rs = do_rs;
    a.bias = (const __nv_bfloat16*)bias;
    a.gate = (const float*)gate;
    a.kpm = (const uint8_t*)kpm;
    a.amask = (const float*)amask;
    a.dq = (float*)dq;
    a.dk = (__nv_bfloat16*)dk;
    a.dv = (__nv_bfloat16*)dv;
    a.dgate = (float*)dgate;
    a.dbias = (float*)dbias;
    a.delta = (float*)delta;
    a.seed = (const long long*)seed;
    a.threshold = threshold;
    a.drop_scale = drop_scale;
    a.T = T; a.S = S; a.H = H;
    a.scale = scale;
    cudaStream_t s = (cudaStream_t)stream;
    const int rows = B * T * H;
    delta_kernel<<<(rows + 31) / 32, 256, 0, s>>>(a, rows);
    const dim3 grid((S + kBKey - 1) / kBKey, H, B);
    flash_bwd_kernel<<<grid, kThreads, kSmemBytes, s>>>(a);
    return (int)cudaGetLastError();
}
