// Blocked causal / non-causal attention with an f32 online softmax,
// with the model path's semantics: per-row q_offset, ragged Skv, GQA.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// flash_attention (body _kernel), and computes the function the model
// path runs in its place, src/repro/models/components.py:
// flash_attention: q (B,Sq,H,Dh), k/v (B,Skv,KVH,Dh) bf16, kv head =
// h / (H / KVH), key j visible to query i of row b iff j < Skv and (if
// causal) j <= q_offset[b] + i; scale 1/sqrt(Dh), masked lanes -1e30,
// p rounded to bf16 before the P.V product, f32 accumulation.  Given
// an lse buffer it also writes each row's log-sum-exp of its scaled
// scores (m + log l), what the training backward (flash_attention_bwd.cu)
// needs; the output's bits do not depend on it.
//
// What bounds it on the H100: at a whole-prompt prefill (Sq of several
// hundred) the tensor-core operations; at a 32-token chunk step the
// bytes of the gathered K/V buffer; at both sizes of the serve path
// (qwen3-0.6b, H 16, KVH 8, Dh 128) in practice the latency of a few
// key tiles per block.  What the design does about it: one block of
// four warps per (64-row q tile, head, batch row); each warp owns 16
// query rows and keeps their Q fragments (ldmatrix), the running max,
// denominator and output accumulator in registers for the whole key
// sweep.  K and V tiles of 64 keys stay bf16 in shared memory (XOR-
// swizzled 16-byte chunks, so ldmatrix is free of bank conflicts),
// double-buffered with cp.async: the next tile loads while this one is
// multiplied.  S = Q K^T and O += P V run as mma.sync m16n8k16 (bf16 x
// bf16 -> f32) on the tensor cores; the online softmax runs on the S
// accumulator fragments, and P is rounded to bf16 and packed straight
// into the A fragments of the P V product (V read with ldmatrix.trans):
// no score tile touches shared memory.  80 KB of shared memory a block
// at Dh 128: two blocks per SM; 160 KB and one block at Dh 256.
//
// Head dims 64, 128 and 256.  At Dh 256 (recurrentgemma's local
// attention) a warp's output accumulator alone is 128 f32 registers, so
// the Q fragments are not kept in registers for the sweep but read
// again from shared memory (ldmatrix) at every k16 step of Q K^T, and
// one 160 KB block runs per SM; the arithmetic is the same.
//
// Sliding window (``window`` > 0): key j is visible to the query at
// position p only if also j > p - window (the reference's mask).  The
// sweep starts at the first tile any row of the q tile can see; a row
// whose window starts in a later tile sees fully masked tiles first,
// where its max stays -1e30 and p = 1 (its l and O are sums of
// garbage), and the first tile with one of its keys multiplies both by
// alpha = exp(-1e30 - m) = 0 exactly, so the row ends with the bits it
// would have had starting at that tile.
//
// Summation structure (what makes chunked == whole prefill bitwise in
// the port): keys are walked in tiles of KV_TILE anchored at absolute
// position 0; within a tile every row's max and denominator are taken
// over the thread's 16 values in one fixed order, then across the
// quad by two xor shuffles (whose result is the same on all four
// lanes); the tensor-core products are elementwise and the same for
// every row position; a tile fully masked for a row is an exact no-op
// of the recurrence (the max against -1e30 cannot win, exp underflows
// to +0.0, alpha is 1, P V adds products of zero).  A row's bits
// therefore depend only on its own keys and offset, whatever its place
// in the q tile: attention over a longer, padded buffer with the same
// leading keys, or over a 32-row chunk at an offset, gives the bits of
// the whole prefill.  The causal loop ends at kend, the last key any
// row of the tile can see.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W, L2 flushed
// before each call): before this design (f32 copies in shared memory,
// FMAs, no asynchronous load) 0.342 ms at a B 2 x 512 prefill and
// 0.0965 ms at a B 8 x C 32 chunk step; with it 0.0312 and 0.0165 ms
// (SDPA with the same mask: 0.0358 and 0.0299 ms).  224 registers a
// thread at Dh 128, no spills.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "attn_mma.cuh"

namespace {

using namespace attn;

constexpr int Q_TILE = 64;     // query rows per block (16 per warp)
constexpr int KV_TILE = 64;    // keys per online-softmax step
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

template <int DH>
constexpr size_t smem_bytes() {
    // q tile, then K and V tiles, double-buffered; all bf16
    return 2 * (size_t)(Q_TILE + 4 * KV_TILE) * DH;
}

// rows [r0, r0 + 64) of a (rows, stride-DH-apart) bf16 matrix whose row
// r starts at g + r * ld, into a swizzled tile; rows >= rows are zero
template <int DH>
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const __nv_bfloat16* g,
                                          size_t ld, int r0, int rows) {
    constexpr int CH = DH / 8;
    for (int idx = threadIdx.x; idx < 64 * CH; idx += THREADS) {
        const int r = idx / CH, c = idx % CH;
        const bool in = r0 + r < rows;
        const __nv_bfloat16* src = g + (in ? (size_t)(r0 + r) * ld : 0) + c * 8;
        cp_async16(dst + swz<DH>(r, c), src, in ? 16 : 0);
    }
}

template <int DH>
__global__ void __launch_bounds__(THREADS, DH > 128 ? 1 : 2)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,   // (B,Sq,H,DH)
                       const __nv_bfloat16* __restrict__ k,   // (B,Skv,KVH,DH)
                       const __nv_bfloat16* __restrict__ v,
                       const int* __restrict__ q_offset,      // (B,)
                       __nv_bfloat16* __restrict__ out,       // (B,Sq,H,DH)
                       float* __restrict__ lse,               // (B,H,Sq) or null
                       int Sq, int Skv, int H, int KVH, int causal,
                       int window, float scale) {
    constexpr int KS = DH / 16;        // k16 steps of Q K^T
    constexpr int ND = DH / 8;         // n8 tiles of the output
    constexpr int TILE = KV_TILE * DH * 2;
    constexpr bool Q_REGS = DH <= 128; // Q fragments kept in registers

    const int q0 = blockIdx.x * Q_TILE;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int kvh = h / (H / KVH);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

    extern __shared__ __align__(128) unsigned char smem[];
    const uint32_t sq = (uint32_t)__cvta_generic_to_shared(smem);
    const uint32_t sk = sq + Q_TILE * DH * 2;     // 2 K tiles
    const uint32_t sv = sk + 2 * TILE;            // 2 V tiles

    const int qoff = q_offset[b];
    int kend = Skv;        // last key any row of this tile can see
    if (causal) kend = min(Skv, qoff + min(q0 + Q_TILE, Sq));
    const int ntiles = (kend + KV_TILE - 1) / KV_TILE;
    // first tile any row of this tile can see (its first row's window)
    const int tbeg = window > 0 ? max(0, qoff + q0 - window + 1) / KV_TILE
                                : 0;

    const size_t kv_ld = (size_t)KVH * DH;
    const __nv_bfloat16* kb = k + ((size_t)b * Skv * KVH + kvh) * DH;
    const __nv_bfloat16* vb = v + ((size_t)b * Skv * KVH + kvh) * DH;
    load_rows<DH>(sq, q + ((size_t)b * Sq * H + h) * DH, (size_t)H * DH, q0,
                  Sq);
    if (tbeg < ntiles) {
        load_rows<DH>(sk, kb, kv_ld, tbeg * KV_TILE, Skv);
        load_rows<DH>(sv, vb, kv_ld, tbeg * KV_TILE, Skv);
    }
    cp_async_commit();

    // this thread's rows: r0 = 16 warp + lane / 4 and r0 + 8
    const int rq = warp * 16 + (lane >> 2);
    const int qpos0 = qoff + q0 + rq, qpos1 = qpos0 + 8;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
    float acc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    uint32_t qf[Q_REGS ? KS : 1][4];

    for (int t = tbeg; t < ntiles; ++t) {
        const int buf = (t - tbeg) & 1;
        if (t + 1 < ntiles) {
            load_rows<DH>(sk + (buf ^ 1) * TILE, kb, kv_ld,
                          (t + 1) * KV_TILE, Skv);
            load_rows<DH>(sv + (buf ^ 1) * TILE, vb, kv_ld,
                          (t + 1) * KV_TILE, Skv);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        if constexpr (Q_REGS) {
            if (t == tbeg) {
#pragma unroll
                for (int ks = 0; ks < KS; ++ks)
                    ldsm_x4(sq + swz<DH>(warp * 16 + (lane & 15),
                                         2 * ks + (lane >> 4)),
                            qf[ks]);
            }
        }
        const uint32_t kt = sk + buf * TILE, vt = sv + buf * TILE;

        // S = Q K^T: 16 rows x 64 keys per warp, 8 n8 tiles
        float s[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
            uint32_t qa[4];
            if constexpr (Q_REGS) {
#pragma unroll
                for (int e = 0; e < 4; ++e) qa[e] = qf[ks][e];
            } else {
                ldsm_x4(sq + swz<DH>(warp * 16 + (lane & 15),
                                     2 * ks + (lane >> 4)),
                        qa);
            }
#pragma unroll
            for (int n = 0; n < 8; n += 2) {
                uint32_t bk[4];
                const int m = lane >> 3;
                ldsm_x4(kt + swz<DH>((n + (m >> 1)) * 8 + (lane & 7),
                                     2 * ks + (m & 1)),
                        bk);
                mma(s[n], qa, bk[0], bk[1]);
                mma(s[n + 1], qa, bk[2], bk[3]);
            }
        }

        // scale, mask, online softmax on the fragments: thread values
        // s[n][0..1] are row r0, s[n][2..3] row r0 + 8, key
        // j0 + 8 n + 2 (lane & 3) + e
        const int j0 = t * KV_TILE;
        float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int j = j0 + 8 * n + 2 * (lane & 3) + e;
                const bool in = j < Skv;
                const bool v0 = in && (!causal || j <= qpos0) &&
                                (window <= 0 || j > qpos0 - window);
                const bool v1 = in && (!causal || j <= qpos1) &&
                                (window <= 0 || j > qpos1 - window);
                s[n][e] = v0 ? s[n][e] * scale : NEG_INF;
                s[n][e + 2] = v1 ? s[n][e + 2] * scale : NEG_INF;
                mx0 = fmaxf(mx0, s[n][e]);
                mx1 = fmaxf(mx1, s[n][e + 2]);
            }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        float ps0 = 0.f, ps1 = 0.f;
        uint32_t pa[4][4];     // P as bf16 A fragments, one per k16 step
#pragma unroll
        for (int n = 0; n < 8; ++n) {
            const float p00 = expf(s[n][0] - mn0), p01 = expf(s[n][1] - mn0);
            const float p10 = expf(s[n][2] - mn1), p11 = expf(s[n][3] - mn1);
            // the denominator sums f32 p; P V takes p rounded to bf16
            ps0 += p00;
            ps0 += p01;
            ps1 += p10;
            ps1 += p11;
            pa[n >> 1][(n & 1) * 2] = pack_bf16(p00, p01);
            pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p10, p11);
        }
        ps0 += __shfl_xor_sync(0xffffffffu, ps0, 1);
        ps0 += __shfl_xor_sync(0xffffffffu, ps0, 2);
        ps1 += __shfl_xor_sync(0xffffffffu, ps1, 1);
        ps1 += __shfl_xor_sync(0xffffffffu, ps1, 2);
        const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
        l0 = l0 * al0 + ps0;
        l1 = l1 * al1 + ps1;
        m0 = mn0;
        m1 = mn1;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
            acc[n][0] *= al0;
            acc[n][1] *= al0;
            acc[n][2] *= al1;
            acc[n][3] *= al1;
        }

        // O += P V: V (keys x DH) read transposed, two n8 tiles a load
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
            for (int n = 0; n < ND; n += 2) {
                uint32_t bv[4];
                ldsm_x4_t(vt + swz<DH>(ks * 16 + (lane & 15), n + (lane >> 4)),
                          bv);
                mma(acc[n], pa[ks], bv[0], bv[1]);
                mma(acc[n + 1], pa[ks], bv[2], bv[3]);
            }
        }
        __syncthreads();   // this buffer is the next prefetch's target
    }

    const float inv0 = fmaxf(l0, 1e-30f), inv1 = fmaxf(l1, 1e-30f);
    const int col = 2 * (lane & 3);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int r = q0 + rq + 8 * half;
        if (r >= Sq) continue;
        const float den = half ? inv1 : inv0;
        // the row's log-sum-exp of the scaled scores, for the backward
        // (written by one thread of the quad; all four hold m and l)
        if (lse != nullptr && (lane & 3) == 0)
            lse[((size_t)b * H + h) * Sq + r] =
                (half ? m1 : m0) + logf(den);
        __nv_bfloat16* o = out + (((size_t)b * Sq + r) * H + h) * DH + col;
#pragma unroll
        for (int n = 0; n < ND; ++n)
            *reinterpret_cast<__nv_bfloat162*>(o + 8 * n) =
                __floats2bfloat162_rn(acc[n][2 * half] / den,
                                      acc[n][2 * half + 1] / den);
    }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const int* q_offset,
           void* out, float* lse, int B, int Sq, int Skv, int H, int KVH,
           int causal, int window, cudaStream_t stream) {
    const size_t smem = smem_bytes<DH>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((Sq + Q_TILE - 1) / Q_TILE, H, B);
    flash_attention_kernel<DH><<<grid, THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), q_offset,
        static_cast<__nv_bfloat16*>(out), lse, Sq, Skv, H, KVH, causal,
        window,
        1.0f / sqrtf((float)DH));
    return (int)cudaGetLastError();
}

}  // namespace

// window: 0 for none, else keys j > position - window only.  lse: null,
// or an f32 (B, H, Sq) buffer that receives each row's log-sum-exp of
// its scaled scores (m + log l; the backward's input), with no effect
// on out.  Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_flash_attention_bf16(
        const void* q, const void* k, const void* v, const void* q_offset,
        void* out, int B, int Sq, int Skv, int H, int KVH, int Dh,
        int causal, int window, void* lse_out, void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    auto qo = static_cast<const int*>(q_offset);
    auto lse = static_cast<float*>(lse_out);
    if (Dh == 64)
        return launch<64>(q, k, v, qo, out, lse, B, Sq, Skv, H, KVH, causal,
                          window, s);
    if (Dh == 128)
        return launch<128>(q, k, v, qo, out, lse, B, Sq, Skv, H, KVH, causal,
                           window, s);
    if (Dh == 256)
        return launch<256>(q, k, v, qo, out, lse, B, Sq, Skv, H, KVH, causal,
                           window, s);
    return (int)cudaErrorInvalidValue;
}
