// Fused attention forward with WavLM's gated relative position bias, in fp32.
//
// Replaces unispeech_tpu/ops/pallas/flash_attention.py::_fwd_kernel
// (head-major layout, launched by _run_forward) and ::_fwd_kernel_packed
// (natural (B, T, H*hd) layout, launched by _run_forward_packed) at fp32,
// the models' default dtype:
//   out = dropout(softmax(q*scale . k^T + gate[b,h,t] * bias[h,t,s]
//                         + attn_mask[t,s] + kPadNeg * (key s padded))) . v
// over the S keys (keys past S, in a tile's tail, take -inf: p = 0) and,
// when asked, lse = max + log(sum) per query row of the undropped
// probabilities, all in fp32. P is not rounded before P.V (the JAX kernel
// rounds it to v's dtype, which in fp32 does nothing). Dropout (kDrop,
// training) multiplies the un-normalised p by keep / (1 - rate) in fp32
// after its row sum is taken, as the bf16 kernel and the TPU kernel do; the
// keep bit of (b, h, t, s) is the Philox function of philox.cuh, so the
// mask is the bf16 kernel's and the plain version's bit for bit.
//
// Bound on the H100: bytes at bf16 rates, operations here. At WavLM-Base+
// width and 4 x 16 s (T = 799) one call does 7.85 GFLOP and must read q, k,
// v and the (H, T, S) fp32 bias (30.6 MB) and write out: 70 MB, 21 us at
// 3.35 TB/s. The products run as the 3xTF32 split (tf32.cuh) on
// mma.sync.m16n8k8, three products per fragment: 23.6 GFLOP of TF32, 48 us
// at its 495 TFLOP/s peak. (A single TF32 pass would miss fp32 by ~1e-3;
// wgmma takes TF32 only with both operands K-major, which V in P.V is not.)
// Design: 4 warps (128 threads) per (64-query tile, head, utterance); each
// warp owns 16 queries. q, then per 64-key step K and V, arrive by 16-byte
// cp.async (rows past T or S as zeros) into shared memory rows of hd + 4
// floats, a stride at which every fragment read below is free of bank
// conflicts; V's copy overlaps S = q.K^T. The S accumulators (16 x 64 per
// warp) are the logits; online softmax in fp32 in natural units, in the
// plain version's order (x = s q.k + g b + mask), p = ex2((x - m) log2e).
// P.V takes P straight from the S accumulators as the A fragments: the
// m16n8k8 A layout wants (row, key t) and (row, key t + 4) where the
// accumulator holds keys 2t and 2t + 1, so the k index of each 8-key step
// is permuted (k t <-> key 2t, k t + 4 <-> key 2t + 1) and V's rows are
// read in the same order: no shuffles. The output is divided by the row
// sum at the end and stored with 8-byte stores. Template on the padded
// width kD (64 or 128, the O accumulator's registers); any hd that is a
// multiple of 8 up to kD runs on it. The keep mask (kDrop): one Philox call
// gives the words of a 2 x 2 (query, key) block. A lane holds query rows g
// and g + 8 and the key pairs (2 tq, 2 tq + 1) of each 8-key group n; the
// lane four apart holds rows g ^ 1 and g ^ 1 + 8, the other rows of the
// same blocks. So each lane draws the blocks of the groups n whose parity
// is its row's, keeps its own row's bits and swaps the other row's with
// its partner by one shuffle: 8 Philox calls per lane and 64-key step. The
// bits are applied to the accumulator elements by their (t, s), before P
// is permuted into the A fragments of P.V.

#include <math.h>

#include "common.cuh"
#include "philox.cuh"
#include "tf32.cuh"

namespace {

constexpr int kBQ = 64;    // queries per block
constexpr int kBKey = 64;  // keys per step
constexpr int kThreads = 128;
constexpr int kMaxHd = 128;
// the padded-key logit: -2^100 absorbs any finite logit it is added to, so
// an all-padded row is uniform over its keys, as the plain softmax's
constexpr float kPadNeg = -1267650600228229401496703205376.0f;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
    const float *q, *k, *v;
    float* out;
    long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs;
    const float* bias;  // (H, T, S) rows bias_rs apart, heads T rows apart
    long long bias_rs;
    const float* gate;     // (B, H, T) or null
    const uint8_t* kpm;    // (B, S) or null
    const float* amask;    // (T, S) or null
    float* lse;            // (B, H, T) or null
    const long long* seed; // dropout seed (1 element) or null: no dropout
    unsigned threshold;    // keep iff the Philox word >= threshold
    float drop_scale;      // 1 / (1 - rate)
    int T, S, H, hd;
    float scale;
};

template <int kD, bool kDrop>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(Args a) {
    extern __shared__ float4 attn_f32_smem[];
    const int hd = a.hd, ld = hd + 4, n4 = hd / 4;
    float* Qs = reinterpret_cast<float*>(attn_f32_smem);
    float* Ks = Qs + kBQ * ld;
    float* Vs = Ks + kBKey * ld;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, tq = lane & 3;
    const int t0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
    const int T = a.T, S = a.S;
    const uint64_t seed = kDrop ? (uint64_t)*a.seed : 0;

    // rows [r0, r0 + 64) of head h of a (B, rows, H, hd) tensor
    auto load_tile = [&](float* dst, const float* src, long long bs, long long rs, int r0,
                         int nrows) {
        for (int i = tid; i < 64 * n4; i += kThreads) {
            const int r = i / n4, c = i % n4;
            const bool ok = r0 + r < nrows;
            const float* p = src + b * bs + (ok ? r0 + r : 0) * rs + (long long)h * hd + 4 * c;
            usk::cp_async16(dst + r * ld + 4 * c, p, ok);
        }
    };
    load_tile(Qs, a.q, a.q_bs, a.q_rs, t0, T);
    usk::cp_async_commit();

    // this thread's query rows: 16 warp + g and + 8
    int trow[2];
    float gate[2] = {1.f, 1.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        trow[i] = t0 + 16 * warp + g + 8 * i;
        if (a.gate != nullptr && trow[i] < T)
            gate[i] = a.gate[((size_t)b * a.H + h) * T + trow[i]];
    }

    float o[kD / 8][4];
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
    const float* qw = Qs + 16 * warp * ld;

    const int n_steps = (S + kBKey - 1) / kBKey;
    for (int step = 0; step < n_steps; ++step) {
        const int s0 = step * kBKey;
        __syncthreads();  // the previous step's K and V are consumed
        load_tile(Ks, a.k, a.k_bs, a.k_rs, s0, S);
        usk::cp_async_commit();
        load_tile(Vs, a.v, a.v_bs, a.v_rs, s0, S);
        usk::cp_async_commit();
        usk::cp_async_wait<1>();  // q and K
        __syncthreads();

        // S = q . K^T: 16 queries x 64 keys per warp
        float sc[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
        for (int d0 = 0; d0 < kD; d0 += 8) {
            if (d0 >= hd) break;
            uint32_t ah[4], al[4];
            const float* qp = qw + g * ld + d0 + tq;
            usk::split_tf32(qp[0], ah[0], al[0]);
            usk::split_tf32(qp[8 * ld], ah[1], al[1]);
            usk::split_tf32(qp[4], ah[2], al[2]);
            usk::split_tf32(qp[8 * ld + 4], ah[3], al[3]);
#pragma unroll
            for (int n = 0; n < 8; ++n) {
                const float* kp = Ks + (8 * n + g) * ld + d0 + tq;
                uint32_t bh0, bl0, bh1, bl1;
                usk::split_tf32(kp[0], bh0, bl0);
                usk::split_tf32(kp[4], bh1, bl1);
                usk::mma_3xtf32(sc[n], ah, al, bh0, bh1, bl0, bl1);
            }
        }

        // the keep bits while the products run: bit 4 n + e of keep is
        // element e of sc[n]
        uint32_t keep = 0xffffffffu;
        if (kDrop) {
            uint32_t own = 0, other = 0;
#pragma unroll
            for (int m = 0; m < 4; ++m) {
                const int n = 2 * m + (g & 1);
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const usk::Philox4 w = usk::philox4x32_10(
                        (uint32_t)((s0 + 8 * n + 2 * tq) >> 1), (uint32_t)(trow[i] >> 1),
                        (uint32_t)h, (uint32_t)b, (uint32_t)seed, (uint32_t)(seed >> 32));
                    // words 0, 1: the even row's keys s, s + 1; 2, 3: the odd row's
                    const uint32_t e0 = (g & 1) ? w.x[2] : w.x[0], e1 = (g & 1) ? w.x[3] : w.x[1];
                    const uint32_t o0 = (g & 1) ? w.x[0] : w.x[2], o1 = (g & 1) ? w.x[1] : w.x[3];
                    const int sh = 4 * n + 2 * i;
                    own |= ((uint32_t)(e0 >= a.threshold) | (uint32_t)(e1 >= a.threshold) << 1) << sh;
                    other |= ((uint32_t)(o0 >= a.threshold) | (uint32_t)(o1 >= a.threshold) << 1)
                             << sh;
                }
            }
            keep = own | __shfl_xor_sync(0xffffffffu, other, 4);
        }

        // logits and the online softmax; element e of sc[n]: query row
        // trow[e >> 1], key s0 + 8 n + 2 tq + (e & 1)
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int s = s0 + 8 * n + 2 * tq + (e & 1), i = e >> 1, t = trow[i];
                float x = sc[n][e] * a.scale;
                if (s >= S) {
                    x = -INFINITY;
                } else {
                    if (t < T) {
                        if (a.bias != nullptr)
                            x = __fadd_rn(x, __fmul_rn(gate[i],
                                                       a.bias[((size_t)h * T + t) * a.bias_rs + s]));
                        if (a.amask != nullptr) x = __fadd_rn(x, a.amask[(size_t)t * S + s]);
                    }
                    if (a.kpm != nullptr && a.kpm[(size_t)b * S + s] != 0) x += kPadNeg;
                }
                sc[n][e] = x;
                mx[i] = fmaxf(mx[i], x);
            }
        float alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
            const float m_new = fmaxf(m_r[i], mx[i]);  // finite: key s0 < S
            alpha[i] = usk::ex2((m_r[i] - m_new) * kLog2e);  // 0 on the first step
            m_r[i] = m_new;
            l_r[i] *= alpha[i];
        }
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int i = e >> 1;
                const float p = usk::ex2((sc[n][e] - m_r[i]) * kLog2e);
                l_r[i] += p;  // the undropped normaliser
                sc[n][e] = !kDrop ? p : (((keep >> (4 * n + e)) & 1u) ? p * a.drop_scale : 0.f);
            }
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
            o[n][0] *= alpha[0];
            o[n][1] *= alpha[0];
            o[n][2] *= alpha[1];
            o[n][3] *= alpha[1];
        }

        usk::cp_async_wait<0>();  // V
        __syncthreads();
        // O += P . V over the step's 8 groups of 8 keys (k index permuted)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            uint32_t ph[4], pl[4];
            usk::split_tf32(sc[j][0], ph[0], pl[0]);  // (g, key 2 tq)
            usk::split_tf32(sc[j][2], ph[1], pl[1]);  // (g + 8, key 2 tq)
            usk::split_tf32(sc[j][1], ph[2], pl[2]);  // (g, key 2 tq + 1)
            usk::split_tf32(sc[j][3], ph[3], pl[3]);  // (g + 8, key 2 tq + 1)
            const float* vp = Vs + (8 * j + 2 * tq) * ld + g;
#pragma unroll
            for (int n = 0; n < kD / 8; ++n) {
                if (8 * n >= hd) break;
                uint32_t bh0, bl0, bh1, bl1;
                usk::split_tf32(vp[8 * n], bh0, bl0);
                usk::split_tf32(vp[ld + 8 * n], bh1, bl1);
                usk::mma_3xtf32(o[n], ph, pl, bh0, bh1, bl0, bl1);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
        l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int t = trow[i];
        if (t >= T) continue;
        float* dst = a.out + b * a.o_bs + t * a.o_rs + (long long)h * hd + 2 * tq;
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
            if (8 * n >= hd) break;
            *reinterpret_cast<float2*>(dst + 8 * n) =
                make_float2(o[n][2 * i] / l_r[i], o[n][2 * i + 1] / l_r[i]);
        }
        if (a.lse != nullptr && tq == 0)
            a.lse[((size_t)b * a.H + h) * T + t] = m_r[i] + logf(l_r[i]);
    }
}

template <int kD>
cudaError_t launch_width(const Args& a, dim3 grid, cudaStream_t st) {
    auto kernel = a.seed != nullptr ? flash_fwd_f32_kernel<kD, true> : flash_fwd_f32_kernel<kD, false>;
    const int smem = (kBQ + 2 * kBKey) * (a.hd + 4) * (int)sizeof(float);
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, st>>>(a);
    return cudaGetLastError();
}

}  // namespace

// q (B, T, H, hd), k / v (B, S, H, hd) fp32 by (batch, row) strides in
// elements, rows of H hd contiguous floats, every row 16-byte aligned; out
// the same for (B, T, H, hd); bias (H, T, S) fp32 with rows bias_rs apart
// and heads T rows apart, or null; gate (B, H, T) fp32 or null; kpm (B, S)
// bool or null; amask (T, S) fp32 or null; lse (B, H, T) fp32 or null;
// seed a 1-element int64 dropout seed or null (no dropout), threshold and
// drop_scale its keep threshold and 1 / (1 - rate); hd a multiple of 8 up
// to 128
extern "C" int usk_flash_attention_fwd_f32(
    const void* q, const void* k, const void* v, void* out,
    long long q_bs, long long q_rs, long long k_bs, long long k_rs,
    long long v_bs, long long v_rs, long long o_bs, long long o_rs,
    const void* bias, long long bias_rs, const void* gate, const void* kpm, const void* amask,
    void* lse, int B, int T, int S, int H, int hd, float scale, const void* seed,
    unsigned threshold, float drop_scale, void* stream) {
    if (hd < 8 || hd > kMaxHd || hd % 8 != 0 || B > 65535 || H > 65535)
        return (int)cudaErrorInvalidValue;
    Args a;
    a.q = (const float*)q;
    a.k = (const float*)k;
    a.v = (const float*)v;
    a.out = (float*)out;
    a.q_bs = q_bs; a.q_rs = q_rs; a.k_bs = k_bs; a.k_rs = k_rs;
    a.v_bs = v_bs; a.v_rs = v_rs; a.o_bs = o_bs; a.o_rs = o_rs;
    a.bias = (const float*)bias;
    a.bias_rs = bias_rs;
    a.gate = (const float*)gate;
    a.kpm = (const uint8_t*)kpm;
    a.amask = (const float*)amask;
    a.lse = (float*)lse;
    a.seed = (const long long*)seed;
    a.threshold = threshold;
    a.drop_scale = drop_scale;
    a.T = T; a.S = S; a.H = H; a.hd = hd;
    a.scale = scale;
    const dim3 grid((T + kBQ - 1) / kBQ, H, B);
    cudaStream_t s = (cudaStream_t)stream;
    if (hd <= 64) return (int)launch_width<64>(a, grid, s);
    return (int)launch_width<128>(a, grid, s);
}
