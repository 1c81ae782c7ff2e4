// Blocked causal / non-causal attention with an f32 online softmax,
// with the model path's semantics: per-row q_offset, ragged Skv, GQA.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// flash_attention (body _kernel), and computes the function the model
// path runs in its place, src/repro/models/components.py:
// flash_attention: q (B,Sq,H,Dh), k/v (B,Skv,KVH,Dh) bf16, kv head =
// h / (H / KVH), key j visible to query i of row b iff j < Skv and (if
// causal) j <= q_offset[b] + i; scale 1/sqrt(Dh), masked lanes -1e30,
// p rounded to bf16 before the P.V product, f32 accumulation.
//
// What bounds it on the H100: at a whole-prompt prefill (Sq of several
// hundred) the tensor-core flops; at a 32-token chunk step the bytes of
// the gathered K/V buffer.  What the design does about it: one block
// per (64-row q tile, head, batch row) keeps its q tile, running max,
// denominator and output accumulator on chip for the whole key sweep,
// stages each 64-key K/V tile in shared memory once for all 64 rows,
// and stops at the causal frontier, so K/V bytes are read once per q
// tile and the (Sq, Skv) score matrix never reaches device memory.
// This first cut multiplies with FMAs on f32 copies in shared memory,
// far below the tensor-core rate; mma/wgmma with TMA-fed tiles is the
// later step.
//
// Summation structure (what makes chunked == whole prefill bitwise in
// the port): keys are walked in tiles of KV_TILE anchored at absolute
// position 0, every reduction inside a tile runs over the same 64 lanes
// in the same order for every row, and a tile fully masked for a row is
// an exact no-op of the recurrence (the max against -1e30 cannot win,
// exp underflows to +0.0, x + 0.0 == x).  A row's bits therefore depend
// only on its own keys and offset: attention over a longer, padded
// buffer with the same leading keys gives the same output.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int Q_TILE = 64;     // query rows per block
constexpr int KV_TILE = 64;    // keys per online-softmax step
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
    for (int o = 16; o > 0; o >>= 1)
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
    for (int o = 16; o > 0; o >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

// 8 bf16 (16 bytes) -> 8 floats
__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* dst) {
    uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = __bfloat162float(e[i]);
}

constexpr int SS = KV_TILE + 1;   // padded score-row stride

template <int DH>
constexpr size_t smem_bytes() {
    return sizeof(float) * (size_t)(Q_TILE * (DH + 1)      // q tile (padded)
                                    + KV_TILE * (DH + 1)   // K tile (padded)
                                    + KV_TILE * DH         // V tile
                                    + Q_TILE * SS          // scores / p
                                    + 3 * Q_TILE);         // m, l, alpha
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,   // (B,Sq,H,DH)
                       const __nv_bfloat16* __restrict__ k,   // (B,Skv,KVH,DH)
                       const __nv_bfloat16* __restrict__ v,
                       const int* __restrict__ q_offset,      // (B,)
                       __nv_bfloat16* __restrict__ out,       // (B,Sq,H,DH)
                       int Sq, int Skv, int H, int KVH, int causal,
                       float scale) {
    constexpr int VEC = DH / 8;
    constexpr int DJ = DH / 32;     // output columns per lane

    const int q0 = blockIdx.x * Q_TILE;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int kvh = h / (H / KVH);
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    extern __shared__ float smem[];
    float* sq = smem;                          // Q_TILE x (DH + 1)
    float* sk = sq + Q_TILE * (DH + 1);        // KV_TILE x (DH + 1)
    float* sv = sk + KV_TILE * (DH + 1);       // KV_TILE x DH
    float* ss = sv + KV_TILE * DH;             // Q_TILE x SS
    float* s_m = ss + Q_TILE * SS;
    float* s_l = s_m + Q_TILE;
    float* s_alpha = s_l + Q_TILE;

    const int qoff = q_offset[b];
    for (int idx = tid; idx < Q_TILE * VEC; idx += THREADS) {
        const int r = idx / VEC, c = (idx % VEC) * 8;
        float tmp[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (q0 + r < Sq)
            load8(q + (((size_t)b * Sq + q0 + r) * H + h) * DH + c, tmp);
#pragma unroll
        for (int i = 0; i < 8; ++i) sq[r * (DH + 1) + c + i] = tmp[i];
    }
    if (tid < Q_TILE) {
        s_m[tid] = NEG_INF;
        s_l[tid] = 0.f;
    }
    // last key any row of this tile can see
    int kend = Skv;
    if (causal) kend = min(Skv, qoff + min(q0 + Q_TILE, Sq));

    // score mapping: rows tr + 16 i, keys tc + 16 jj
    const int tr = tid / 16, tc = tid % 16;
    // P.V mapping: rows warp + 8 i, columns lane + 32 jj
    float acc[8][DJ];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
    __syncthreads();

    for (int j0 = 0; j0 < kend; j0 += KV_TILE) {
        for (int idx = tid; idx < KV_TILE * VEC; idx += THREADS) {
            const int key = idx / VEC, c = (idx % VEC) * 8;
            float kt[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
            float vt[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
            if (j0 + key < Skv) {
                const size_t off =
                    (((size_t)b * Skv + j0 + key) * KVH + kvh) * DH + c;
                load8(k + off, kt);
                load8(v + off, vt);
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                sk[key * (DH + 1) + c + i] = kt[i];
                sv[key * DH + c + i] = vt[i];
            }
        }
        __syncthreads();

        {
            float dot[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) dot[i][jj] = 0.f;
#pragma unroll 4
            for (int e = 0; e < DH; ++e) {
                float qa[4], kb[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) qa[i] = sq[(tr + 16 * i) * (DH + 1) + e];
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) kb[jj] = sk[(tc + 16 * jj) * (DH + 1) + e];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int jj = 0; jj < 4; ++jj)
                        dot[i][jj] = fmaf(qa[i], kb[jj], dot[i][jj]);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int r = tr + 16 * i;
                const int qpos = qoff + q0 + r;
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) {
                    const int c = tc + 16 * jj;
                    const int j = j0 + c;
                    const bool ok = j < Skv && (!causal || j <= qpos);
                    ss[r * SS + c] = ok ? dot[i][jj] * scale : NEG_INF;
                }
            }
        }
        __syncthreads();

        // online-softmax update, one warp per row
        for (int r = warp; r < Q_TILE; r += THREADS / 32) {
            const float x0 = ss[r * SS + lane];
            const float x1 = ss[r * SS + lane + 32];
            const float m_prev = s_m[r];
            const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
            const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
            const float psum = warp_sum(p0 + p1);
            // P.V takes p rounded to bf16; the denominator sums f32 p
            ss[r * SS + lane] = __bfloat162float(__float2bfloat16(p0));
            ss[r * SS + lane + 32] = __bfloat162float(__float2bfloat16(p1));
            if (lane == 0) {
                const float alpha = expf(m_prev - m_new);
                s_alpha[r] = alpha;
                s_l[r] = s_l[r] * alpha + psum;
                s_m[r] = m_new;
            }
        }
        __syncthreads();

#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int r = warp + 8 * i;
            const float* pr = ss + r * SS;
            float pv[DJ];
#pragma unroll
            for (int jj = 0; jj < DJ; ++jj) pv[jj] = 0.f;
#pragma unroll 8
            for (int c = 0; c < KV_TILE; ++c) {
                const float p = pr[c];
#pragma unroll
                for (int jj = 0; jj < DJ; ++jj)
                    pv[jj] = fmaf(p, sv[c * DH + lane + 32 * jj], pv[jj]);
            }
            const float alpha = s_alpha[r];
#pragma unroll
            for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = acc[i][jj] * alpha + pv[jj];
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int r = warp + 8 * i;
        if (q0 + r < Sq) {
            __nv_bfloat16* o = out + (((size_t)b * Sq + q0 + r) * H + h) * DH;
#pragma unroll
            for (int jj = 0; jj < DJ; ++jj)
                o[lane + 32 * jj] = __float2bfloat16(acc[i][jj] / fmaxf(s_l[r], 1e-30f));
        }
    }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const int* q_offset,
           void* out, int B, int Sq, int Skv, int H, int KVH, int causal,
           cudaStream_t stream) {
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
        static_cast<__nv_bfloat16*>(out), Sq, Skv, H, KVH, causal,
        1.0f / sqrtf((float)DH));
    return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_flash_attention_bf16(
        const void* q, const void* k, const void* v, const void* q_offset,
        void* out, int B, int Sq, int Skv, int H, int KVH, int Dh,
        int causal, void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    auto qo = static_cast<const int*>(q_offset);
    if (Dh == 64)
        return launch<64>(q, k, v, qo, out, B, Sq, Skv, H, KVH, causal, s);
    if (Dh == 128)
        return launch<128>(q, k, v, qo, out, B, Sq, Skv, H, KVH, causal, s);
    return (int)cudaErrorInvalidValue;
}
