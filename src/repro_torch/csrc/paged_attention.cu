// Paged attention over a bf16 KV page pool: decode (T = 1) and
// speculative verification (T > 1) in one kernel.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py:
// paged_attention_kernel (body _kernel), and computes the model path's
// function, src/repro/kernels/paged_attention/ref.py:
// paged_verify_attention_ref (which covers paged_attention_ref at T = 1):
// query (b, t) sits at absolute position lengths[b] + t and attends the
// gathered keys j <= lengths[b] + t (clipped to the n * ps keys the
// table covers), scale 1/sqrt(Dh), masked lanes -1e30, f32 online
// softmax, p rounded to bf16 before the P.V product, f32 accumulation.
//
// What bounds it on the H100: the K/V bytes it reads.  The work is
// ~4 flops per K/V element for T * G <= 16 query rows, far below the
// ~295 flops/byte ridge of bf16, so the bound is the K/V bytes over
// 3.35 TB/s.  What the design does about it: one block per
// (b, kv-head, <=16 query rows) stages each 64-key K/V tile in shared
// memory ONCE (16-byte loads, the page id read per key from the table
// in global memory) and serves all T * G query rows of the GQA group
// from it, so K/V bytes are read once per kv head, not once per query
// head or per draft token.  Pages past a row's length are never read.
// This first cut computes with FMAs on f32 copies in shared memory;
// mma/wgmma and split-K over the keys (to fill 132 SMs at small B) are
// for later.
//
// Summation structure (what makes the port's bitwise invariants hold):
// keys are walked in tiles of KV_TILE anchored at position 0,
// independent of the page size and of the table width, and a row's
// result depends only on its own keys: a tile that is fully masked for
// a row is an exact no-op of the online-softmax recurrence.  So the
// contiguous decode (the cache viewed as one page per row), the paged
// decode and the verify step at T = 1 produce the same bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int KV_TILE = 64;    // keys per online-softmax step
constexpr int MAX_ROWS = 16;   // query rows (t, g) per block
constexpr int THREADS = 128;
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

template <int DH>
constexpr size_t smem_bytes() {
    return sizeof(float) * (size_t)(MAX_ROWS * DH          // q rows
                                    + KV_TILE * (DH + 1)   // K tile (padded)
                                    + KV_TILE * DH         // V tile
                                    + MAX_ROWS * KV_TILE   // scores / p
                                    + 3 * MAX_ROWS);       // m, l, alpha
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,        // (B,T,H,DH)
                       const __nv_bfloat16* __restrict__ k_pages,  // (P,ps,KVH,DH)
                       const __nv_bfloat16* __restrict__ v_pages,
                       const int* __restrict__ tables,             // (B,n)
                       const int* __restrict__ lengths,            // (B,)
                       __nv_bfloat16* __restrict__ out,            // (B,T,H,DH)
                       int T, int H, int KVH, int ps, int n, float scale) {
    constexpr int VEC = DH / 8;                 // 16-byte vectors per row
    constexpr int RSTEP = THREADS / DH;         // rows between a thread's accumulators
    constexpr int NACC = MAX_ROWS / RSTEP;      // accumulators per thread

    const int b = blockIdx.x;
    const int kvh = blockIdx.y;
    const int r0 = blockIdx.z * MAX_ROWS;
    const int G = H / KVH;
    const int rows = min(MAX_ROWS, T * G - r0);
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    extern __shared__ float smem[];
    float* sq = smem;                         // MAX_ROWS x DH
    float* sk = sq + MAX_ROWS * DH;           // KV_TILE x (DH + 1)
    float* sv = sk + KV_TILE * (DH + 1);      // KV_TILE x DH
    float* ss = sv + KV_TILE * DH;            // MAX_ROWS x KV_TILE
    float* s_m = ss + MAX_ROWS * KV_TILE;
    float* s_l = s_m + MAX_ROWS;
    float* s_alpha = s_l + MAX_ROWS;
    __shared__ int s_limit[MAX_ROWS];

    const int len = lengths[b];
    const int cover = n * ps;                 // keys the table row covers
    const int* tbl = tables + (size_t)b * n;

    for (int idx = tid; idx < MAX_ROWS * VEC; idx += THREADS) {
        const int r = idx / VEC, c = (idx % VEC) * 8;
        float tmp[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (r < rows) {
            const int rr = r0 + r, t = rr / G, g = rr % G;
            load8(q + (((size_t)b * T + t) * H + kvh * G + g) * DH + c, tmp);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) sq[r * DH + c + i] = tmp[i];
    }
    if (tid < MAX_ROWS) {
        int lim = 0;
        if (tid < rows) lim = min(len + (r0 + tid) / G + 1, cover);
        s_limit[tid] = lim;
        s_m[tid] = NEG_INF;
        s_l[tid] = 0.f;
    }
    // rows are in increasing t order: the last one reaches furthest
    const int kmax = min(len + (r0 + rows - 1) / G + 1, cover);

    float acc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
    const int d = tid % DH;
    const int rbase = tid / DH;
    __syncthreads();

    for (int j0 = 0; j0 < kmax; j0 += KV_TILE) {
        // stage the K/V tile: each key's page id comes from the table
        for (int idx = tid; idx < KV_TILE * VEC; idx += THREADS) {
            const int key = idx / VEC, c = (idx % VEC) * 8;
            const int j = j0 + key;
            float kt[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
            float vt[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
            if (j < kmax) {
                const int page = tbl[j / ps];
                const size_t off =
                    (((size_t)page * ps + (j % ps)) * KVH + kvh) * DH + c;
                load8(k_pages + off, kt);
                load8(v_pages + off, vt);
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                sk[key * (DH + 1) + c + i] = kt[i];
                sv[key * DH + c + i] = vt[i];
            }
        }
        __syncthreads();

        // scores: consecutive threads take consecutive keys of one row
        for (int idx = tid; idx < MAX_ROWS * KV_TILE; idx += THREADS) {
            const int r = idx / KV_TILE, c = idx % KV_TILE;
            float s = NEG_INF;
            if (r < rows && j0 + c < s_limit[r]) {
                const float* qr = sq + r * DH;
                const float* kr = sk + c * (DH + 1);
                float dot = 0.f;
#pragma unroll 16
                for (int e = 0; e < DH; ++e) dot = fmaf(qr[e], kr[e], dot);
                s = dot * scale;
            }
            ss[idx] = s;
        }
        __syncthreads();

        // online-softmax update, one warp per row
        for (int r = warp; r < rows; r += THREADS / 32) {
            const float x0 = ss[r * KV_TILE + lane];
            const float x1 = ss[r * KV_TILE + lane + 32];
            const float m_prev = s_m[r];
            const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
            const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
            const float psum = warp_sum(p0 + p1);
            // P.V takes p rounded to bf16; the denominator sums f32 p
            ss[r * KV_TILE + lane] = __bfloat162float(__float2bfloat16(p0));
            ss[r * KV_TILE + lane + 32] = __bfloat162float(__float2bfloat16(p1));
            if (lane == 0) {
                const float alpha = expf(m_prev - m_new);
                s_alpha[r] = alpha;
                s_l[r] = s_l[r] * alpha + psum;
                s_m[r] = m_new;
            }
        }
        __syncthreads();

#pragma unroll
        for (int i = 0; i < NACC; ++i) {
            const int r = rbase + i * RSTEP;
            if (r < rows) {
                const float* pr = ss + r * KV_TILE;
                float pv = 0.f;
#pragma unroll 16
                for (int c = 0; c < KV_TILE; ++c) pv = fmaf(pr[c], sv[c * DH + d], pv);
                acc[i] = acc[i] * s_alpha[r] + pv;
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < NACC; ++i) {
        const int r = rbase + i * RSTEP;
        if (r < rows) {
            const int rr = r0 + r, t = rr / G, g = rr % G;
            out[(((size_t)b * T + t) * H + kvh * G + g) * DH + d] =
                __float2bfloat16(acc[i] / fmaxf(s_l[r], 1e-30f));
        }
    }
}

template <int DH>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* tables, const int* lengths, void* out,
           int B, int T, int H, int KVH, int ps, int n, cudaStream_t stream) {
    const size_t smem = smem_bytes<DH>();
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int G = H / KVH;
    dim3 grid(B, KVH, (T * G + MAX_ROWS - 1) / MAX_ROWS);
    paged_attention_kernel<DH><<<grid, THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k_pages),
        static_cast<const __nv_bfloat16*>(v_pages), tables, lengths,
        static_cast<__nv_bfloat16*>(out), T, H, KVH, ps, n,
        1.0f / sqrtf((float)DH));
    return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_paged_attention_bf16(
        const void* q, const void* k_pages, const void* v_pages,
        const void* tables, const void* lengths, void* out,
        int B, int T, int H, int KVH, int Dh, int ps, int n, void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    auto tb = static_cast<const int*>(tables);
    auto ln = static_cast<const int*>(lengths);
    if (Dh == 64)
        return launch<64>(q, k_pages, v_pages, tb, ln, out, B, T, H, KVH, ps, n, s);
    if (Dh == 128)
        return launch<128>(q, k_pages, v_pages, tb, ln, out, B, T, H, KVH, ps, n, s);
    return (int)cudaErrorInvalidValue;
}
