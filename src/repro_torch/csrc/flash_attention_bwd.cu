// The backward of the flash attention kernel (flash_attention.cu):
// given q, k, v, the forward's output o, its per-row log-sum-exp lse
// and the output's gradient do, the gradients dq, dk and dv.
//
// Replaces the JAX package's autodiff of the attention its model path
// differentiates, src/repro/models/components.py:flash_attention (the
// jnp online softmax, rematerialised per layer): the TPU kernel
// src/repro/kernels/flash_attention/kernel.py has no backward.  It
// computes the analytic gradient of softmax(q k^T scale) v, with the
// forward's mask (key j visible to query i iff j < S and, if causal,
// j <= i; q_offset 0 and Sq == Skv = S) and GQA (kv head h / G):
//
//     D  = rowsum(do * o)                      (f32, per query row)
//     P  = exp(S scale - lse)                  (f32)
//     dV = sum over the G heads of P^T do
//     dP = do V^T
//     dS = P * (dP - D)
//     dQ = dS K scale,  dK = sum over the G heads of dS^T Q scale
//
// bf16 operands on the tensor cores (mma.sync m16n8k16, f32
// accumulation): P and dS are rounded to bf16 where they enter a
// product, as the forward rounds P before P V; dq, dk, dv are rounded
// to bf16 once, at the end.
//
// Deterministic by construction: no atomics.  Two kernels, launched in
// this order on one stream:
//   * flash_bwd_dq: one block per (64-row query tile, head, batch row).
//     It first computes D of its rows (each row's 4-lane quad sums a
//     fixed quarter of Dh each, then two xor shuffles) and writes it
//     out for the second kernel, then walks the key tiles (64 keys,
//     anchored at 0, as the forward) in ascending order up to the
//     causal frontier, recomputing P and dS, and accumulates dQ in
//     registers.
//   * flash_bwd_dkdv: one block per (64-key tile, kv head, batch row).
//     It walks the G query heads of its kv head in order and, for each,
//     the query tiles from the key tile's diagonal (causal) or from 0,
//     in ascending order, each in two halves of 32 rows; dK and dV of
//     its 64 keys stay in registers for the whole walk, so the sum over
//     heads and query tiles is one fixed order.
// Each output element is written by exactly one thread, once.
//
// What bounds it on the H100: at qwen3-0.6b's training shape (B 8,
// S 256, H 16, KVH 8, Dh 128) the tensor-core operations of seven
// 64 x 64 x Dh products a tile pair (the minimum is five: S and dP are
// recomputed in both kernels), and at S 256 the latency of a few tiles
// a block.  Design: four warps, 16 rows (dq) or 16 keys (dkdv) each,
// accumulators in registers; the streamed tiles (K/V in dq, Q/do with
// their lse and D in dkdv) double-buffered in shared memory with
// cp.async, XOR-swizzled 16-byte chunks read with ldmatrix (plain or
// transposed) as in the forward; P and dS go from the accumulator
// fragments straight into the A fragments of the next product.  96 KB
// (dq) and 97 KB (dkdv) of shared memory a block at Dh 128: two blocks
// an SM.  A simple kernel: wgmma and TMA are later work.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W, L2 flushed
// before each call): 0.111 ms at B 8 x S 256 (SDPA's backward on the
// same mask: 0.149 ms; bound 0.015 ms, bytes) and 0.594 ms at B 1 x
// S 2,048 (SDPA 0.270 ms; bound 0.043 ms, operations), where each dK/dV
// block walks 2 heads x up to 32 query tiles alone.  dkdv uses 255
// registers at Dh 128 with a 32-byte spill; dq 236.
//
// Head dims 64 and 128.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "attn_mma.cuh"

namespace {

using namespace attn;

constexpr int TILE = 64;       // query rows / keys a tile (the forward's)
constexpr int THREADS = 128;   // four warps

// rows [r0, r0 + 64) of a (rows, ld-apart) bf16 matrix into a swizzled
// tile; rows >= rows are zero (the forward's load_rows)
template <int DH>
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const __nv_bfloat16* g,
                                          size_t ld, int r0, int rows) {
    constexpr int CH = DH / 8;
    for (int idx = threadIdx.x; idx < TILE * CH; idx += THREADS) {
        const int r = idx / CH, c = idx % CH;
        const bool in = r0 + r < rows;
        const __nv_bfloat16* src = g + (in ? (size_t)(r0 + r) * ld : 0) + c * 8;
        cp_async16(dst + swz<DH>(r, c), src, in ? 16 : 0);
    }
}

template <int DH>
constexpr size_t dq_smem_bytes() {
    // q tile, do tile, then K and V tiles, double-buffered; all bf16
    return (size_t)6 * TILE * DH * 2;
}

template <int DH>
constexpr size_t dkdv_smem_bytes() {
    // K and V tiles, (q, do) tile pairs double-buffered, then lse and D
    // of the two buffered query tiles
    return (size_t)6 * TILE * DH * 2 + 4 * TILE * sizeof(float);
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dq(const __nv_bfloat16* __restrict__ q,    // (B,S,H,DH)
             const __nv_bfloat16* __restrict__ k,    // (B,S,KVH,DH)
             const __nv_bfloat16* __restrict__ v,
             const __nv_bfloat16* __restrict__ o,    // (B,S,H,DH)
             const __nv_bfloat16* __restrict__ dout, // (B,S,H,DH)
             const float* __restrict__ lse,          // (B,H,S)
             float* __restrict__ dsum,               // (B,H,S) out: D
             __nv_bfloat16* __restrict__ dq,         // (B,S,H,DH)
             int S, int H, int KVH, int causal, float scale) {
    constexpr int KS = DH / 16;
    constexpr int ND = DH / 8;
    constexpr int KT = TILE * DH * 2;   // bytes of one tile

    const int q0 = blockIdx.x * TILE;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int kvh = h / (H / KVH);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

    extern __shared__ __align__(128) unsigned char smem[];
    const uint32_t sq = (uint32_t)__cvta_generic_to_shared(smem);
    const uint32_t sdo = sq + KT;
    const uint32_t sk = sdo + KT;        // 2 K tiles
    const uint32_t sv = sk + 2 * KT;     // 2 V tiles

    const size_t q_ld = (size_t)H * DH, kv_ld = (size_t)KVH * DH;
    const __nv_bfloat16* qb = q + ((size_t)b * S * H + h) * DH;
    const __nv_bfloat16* dob = dout + ((size_t)b * S * H + h) * DH;
    const __nv_bfloat16* kb = k + ((size_t)b * S * KVH + kvh) * DH;
    const __nv_bfloat16* vb = v + ((size_t)b * S * KVH + kvh) * DH;
    const int kend = causal ? min(S, q0 + TILE) : S;
    const int ntiles = (kend + TILE - 1) / TILE;

    load_rows<DH>(sq, qb, q_ld, q0, S);
    load_rows<DH>(sdo, dob, q_ld, q0, S);
    load_rows<DH>(sk, kb, kv_ld, 0, S);
    load_rows<DH>(sv, vb, kv_ld, 0, S);
    cp_async_commit();

    // this thread's rows r0 = q0 + 16 warp + lane / 4 and r0 + 8
    const int rq = warp * 16 + (lane >> 2);
    const int row0 = q0 + rq, row1 = row0 + 8;
    const size_t lrow = ((size_t)b * H + h) * S;

    // D of the two rows: lane (lane & 3) of the quad sums the products
    // of its quarter of Dh in order, then the quad adds the quarters
    float d0 = 0.f, d1 = 0.f;
    {
        constexpr int QW = DH / 4;
        const int c0 = (lane & 3) * QW;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int r = half ? row1 : row0;
            float acc = 0.f;
            if (r < S) {
                const size_t base = (((size_t)b * S + r) * H + h) * DH + c0;
                const __nv_bfloat162* op =
                    reinterpret_cast<const __nv_bfloat162*>(o + base);
                const __nv_bfloat162* dp =
                    reinterpret_cast<const __nv_bfloat162*>(dout + base);
#pragma unroll 8
                for (int i = 0; i < QW / 2; ++i) {
                    const float2 a = __bfloat1622float2(op[i]);
                    const float2 c = __bfloat1622float2(dp[i]);
                    acc += a.x * c.x;
                    acc += a.y * c.y;
                }
            }
            acc += __shfl_xor_sync(0xffffffffu, acc, 1);
            acc += __shfl_xor_sync(0xffffffffu, acc, 2);
            if (half) d1 = acc; else d0 = acc;
        }
        if ((lane & 3) == 0) {
            if (row0 < S) dsum[lrow + row0] = d0;
            if (row1 < S) dsum[lrow + row1] = d1;
        }
    }
    const float lse0 = row0 < S ? lse[lrow + row0] : 0.f;
    const float lse1 = row1 < S ? lse[lrow + row1] : 0.f;

    float acc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    for (int t = 0; t < ntiles; ++t) {
        const int buf = t & 1;
        if (t + 1 < ntiles) {
            load_rows<DH>(sk + (buf ^ 1) * KT, kb, kv_ld, (t + 1) * TILE, S);
            load_rows<DH>(sv + (buf ^ 1) * KT, vb, kv_ld, (t + 1) * TILE, S);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const uint32_t kt = sk + buf * KT, vt = sv + buf * KT;

        // S = Q K^T and dP = dO V^T: 16 rows x 64 keys a warp
        float s[8][4], dp[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
            uint32_t qa[4], da[4];
            ldsm_x4(sq + swz<DH>(warp * 16 + (lane & 15), 2 * ks + (lane >> 4)),
                    qa);
            ldsm_x4(sdo + swz<DH>(warp * 16 + (lane & 15), 2 * ks + (lane >> 4)),
                    da);
#pragma unroll
            for (int n = 0; n < 8; n += 2) {
                const int m = lane >> 3;
                uint32_t bk[4], bv[4];
                ldsm_x4(kt + swz<DH>((n + (m >> 1)) * 8 + (lane & 7),
                                     2 * ks + (m & 1)),
                        bk);
                ldsm_x4(vt + swz<DH>((n + (m >> 1)) * 8 + (lane & 7),
                                     2 * ks + (m & 1)),
                        bv);
                mma(s[n], qa, bk[0], bk[1]);
                mma(s[n + 1], qa, bk[2], bk[3]);
                mma(dp[n], da, bv[0], bv[1]);
                mma(dp[n + 1], da, bv[2], bv[3]);
            }
        }

        // P = exp(S scale - lse) on the visible keys, dS = P (dP - D),
        // packed to bf16 A fragments (one per k16 step of 16 keys)
        const int j0 = t * TILE;
        uint32_t dsa[4][4];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
            float ds[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int j = j0 + 8 * n + 2 * (lane & 3) + (e & 1);
                const int r = e < 2 ? row0 : row1;
                const bool vis = r < S && j < S && (!causal || j <= r);
                const float p = vis ? expf(s[n][e] * scale -
                                           (e < 2 ? lse0 : lse1))
                                    : 0.f;
                ds[e] = p * (dp[n][e] - (e < 2 ? d0 : d1));
            }
            dsa[n >> 1][(n & 1) * 2] = pack_bf16(ds[0], ds[1]);
            dsa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }

        // dQ += dS K: K (keys x DH) read transposed, two n8 tiles a load
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
            for (int n = 0; n < ND; n += 2) {
                uint32_t bk[4];
                ldsm_x4_t(kt + swz<DH>(ks * 16 + (lane & 15), n + (lane >> 4)),
                          bk);
                mma(acc[n], dsa[ks], bk[0], bk[1]);
                mma(acc[n + 1], dsa[ks], bk[2], bk[3]);
            }
        }
        __syncthreads();   // this buffer is the next prefetch's target
    }

    const int col = 2 * (lane & 3);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int r = half ? row1 : row0;
        if (r >= S) continue;
        __nv_bfloat16* out = dq + (((size_t)b * S + r) * H + h) * DH + col;
#pragma unroll
        for (int n = 0; n < ND; ++n)
            *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) =
                __floats2bfloat162_rn(acc[n][2 * half] * scale,
                                      acc[n][2 * half + 1] * scale);
    }
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dkdv(const __nv_bfloat16* __restrict__ q,    // (B,S,H,DH)
               const __nv_bfloat16* __restrict__ k,    // (B,S,KVH,DH)
               const __nv_bfloat16* __restrict__ v,
               const __nv_bfloat16* __restrict__ dout, // (B,S,H,DH)
               const float* __restrict__ lse,          // (B,H,S)
               const float* __restrict__ dsum,         // (B,H,S): D
               __nv_bfloat16* __restrict__ dk,         // (B,S,KVH,DH)
               __nv_bfloat16* __restrict__ dv,
               int S, int H, int KVH, int causal, float scale) {
    constexpr int KS = DH / 16;
    constexpr int ND = DH / 8;
    constexpr int KT = TILE * DH * 2;

    const int k0 = blockIdx.x * TILE;
    const int kvh = blockIdx.y;
    const int b = blockIdx.z;
    const int G = H / KVH;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

    extern __shared__ __align__(128) unsigned char smem[];
    const uint32_t sk = (uint32_t)__cvta_generic_to_shared(smem);
    const uint32_t sv = sk + KT;
    const uint32_t sqd = sv + KT;        // 2 x (q tile, do tile)
    float* slse = reinterpret_cast<float*>(smem + 6 * KT);   // 2 x 64
    float* sdd = slse + 2 * TILE;                            // 2 x 64

    const size_t q_ld = (size_t)H * DH, kv_ld = (size_t)KVH * DH;
    const int nq = (S + TILE - 1) / TILE;
    const int qt0 = causal ? blockIdx.x : 0;   // the diagonal tile
    const int per_head = nq - qt0;
    const int iters = G * per_head;

    // iteration it: head kvh G + it / per_head, query tile
    // qt0 + it % per_head, into buffer buf
    auto issue = [&](int it, int buf) {
        const int h = kvh * G + it / per_head;
        const int qs = (qt0 + it % per_head) * TILE;
        const size_t off = ((size_t)b * S * H + h) * DH;
        const uint32_t dst = sqd + buf * 2 * KT;
        load_rows<DH>(dst, q + off, q_ld, qs, S);
        load_rows<DH>(dst + KT, dout + off, q_ld, qs, S);
        const int r = qs + (threadIdx.x & (TILE - 1));
        const float* src = threadIdx.x < TILE ? lse : dsum;
        float* to = threadIdx.x < TILE ? slse : sdd;
        to[buf * TILE + (threadIdx.x & (TILE - 1))] =
            r < S ? src[((size_t)b * H + h) * S + r] : 0.f;
    };

    load_rows<DH>(sk, k + ((size_t)b * S * KVH + kvh) * DH, kv_ld, k0, S);
    load_rows<DH>(sv, v + ((size_t)b * S * KVH + kvh) * DH, kv_ld, k0, S);
    issue(0, 0);
    cp_async_commit();

    // this thread's keys: kr0 = k0 + 16 warp + lane / 4 and kr0 + 8
    const int kr = warp * 16 + (lane >> 2);
    const int key0 = k0 + kr, key1 = key0 + 8;

    float adk[ND][4], adv[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;

    for (int it = 0; it < iters; ++it) {
        const int buf = it & 1;
        if (it + 1 < iters) {
            issue(it + 1, buf ^ 1);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const uint32_t qt = sqd + buf * 2 * KT, dot = qt + KT;
        const float* tl = slse + buf * TILE;
        const float* td = sdd + buf * TILE;
        const int qs = (qt0 + it % per_head) * TILE;

#pragma unroll
        for (int hq = 0; hq < 2; ++hq) {      // 32 query rows at a time
            // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 queries a warp
            float st[4][4], dpt[4][4];
#pragma unroll
            for (int n = 0; n < 4; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
                uint32_t ka[4], va[4];
                ldsm_x4(sk + swz<DH>(warp * 16 + (lane & 15),
                                     2 * ks + (lane >> 4)),
                        ka);
                ldsm_x4(sv + swz<DH>(warp * 16 + (lane & 15),
                                     2 * ks + (lane >> 4)),
                        va);
#pragma unroll
                for (int n = 0; n < 4; n += 2) {
                    const int m = lane >> 3;
                    const int r = (hq * 4 + n + (m >> 1)) * 8 + (lane & 7);
                    uint32_t bq[4], bd[4];
                    ldsm_x4(qt + swz<DH>(r, 2 * ks + (m & 1)), bq);
                    ldsm_x4(dot + swz<DH>(r, 2 * ks + (m & 1)), bd);
                    mma(st[n], ka, bq[0], bq[1]);
                    mma(st[n + 1], ka, bq[2], bq[3]);
                    mma(dpt[n], va, bd[0], bd[1]);
                    mma(dpt[n + 1], va, bd[2], bd[3]);
                }
            }

            // P^T and dS^T: values e of n8 tile n are key kr (+8 for
            // e >= 2), query qs + 32 hq + 8 n + 2 (lane & 3) + (e & 1)
            uint32_t pa[2][4], dsa[2][4];
#pragma unroll
            for (int n = 0; n < 4; ++n) {
                float p[4], ds[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int c = hq * 32 + 8 * n + 2 * (lane & 3) + (e & 1);
                    const int i = qs + c;
                    const int j = e < 2 ? key0 : key1;
                    const bool vis = i < S && j < S && (!causal || j <= i);
                    p[e] = vis ? expf(st[n][e] * scale - tl[c]) : 0.f;
                    ds[e] = p[e] * (dpt[n][e] - td[c]);
                }
                pa[n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
                pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
                dsa[n >> 1][(n & 1) * 2] = pack_bf16(ds[0], ds[1]);
                dsa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
            }

            // dV += P^T dO and dK += dS^T Q: dO and Q (queries x DH)
            // read transposed, two n8 tiles a load
#pragma unroll
            for (int ks = 0; ks < 2; ++ks) {
                const int r = hq * 32 + ks * 16 + (lane & 15);
#pragma unroll
                for (int n = 0; n < ND; n += 2) {
                    uint32_t bd[4], bq[4];
                    ldsm_x4_t(dot + swz<DH>(r, n + (lane >> 4)), bd);
                    ldsm_x4_t(qt + swz<DH>(r, n + (lane >> 4)), bq);
                    mma(adv[n], pa[ks], bd[0], bd[1]);
                    mma(adv[n + 1], pa[ks], bd[2], bd[3]);
                    mma(adk[n], dsa[ks], bq[0], bq[1]);
                    mma(adk[n + 1], dsa[ks], bq[2], bq[3]);
                }
            }
        }
        __syncthreads();   // this buffer is the next prefetch's target
    }

    const int col = 2 * (lane & 3);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int j = half ? key1 : key0;
        if (j >= S) continue;
        const size_t base = (((size_t)b * S + j) * KVH + kvh) * DH + col;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
            *reinterpret_cast<__nv_bfloat162*>(dk + base + 8 * n) =
                __floats2bfloat162_rn(adk[n][2 * half] * scale,
                                      adk[n][2 * half + 1] * scale);
            *reinterpret_cast<__nv_bfloat162*>(dv + base + 8 * n) =
                __floats2bfloat162_rn(adv[n][2 * half],
                                      adv[n][2 * half + 1]);
        }
    }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* dsum, void* dq,
           void* dk, void* dv, int B, int S, int H, int KVH, int causal,
           cudaStream_t stream) {
    using bf = __nv_bfloat16;
    const size_t s1 = dq_smem_bytes<DH>(), s2 = dkdv_smem_bytes<DH>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)s1);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(
        flash_bwd_dkdv<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)s2);
    if (err != cudaSuccess) return (int)err;
    const float scale = 1.0f / sqrtf((float)DH);
    const dim3 grid((S + TILE - 1) / TILE, H, B);
    flash_bwd_dq<DH><<<grid, THREADS, s1, stream>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k),
        static_cast<const bf*>(v), static_cast<const bf*>(o),
        static_cast<const bf*>(dout), lse, dsum, static_cast<bf*>(dq), S, H,
        KVH, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 grid2((S + TILE - 1) / TILE, KVH, B);
    flash_bwd_dkdv<DH><<<grid2, THREADS, s2, stream>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k),
        static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, dsum,
        static_cast<bf*>(dk), static_cast<bf*>(dv), S, H, KVH, causal,
        scale);
    return (int)cudaGetLastError();
}

}  // namespace

// q, o, dout, dq: (B, S, H, Dh); k, v, dk, dv: (B, S, KVH, Dh), all bf16
// and contiguous; lse: the forward's (B, H, S) f32 log-sum-exp; dsum: an
// f32 (B, H, S) scratch buffer that receives D = rowsum(dout * o).
// Returns the cudaError_t of the launches (0 on success).
extern "C" int repro_flash_attention_bwd_bf16(
        const void* q, const void* k, const void* v, const void* o,
        const void* dout, const void* lse, void* dsum, void* dq, void* dk,
        void* dv, int B, int S, int H, int KVH, int Dh, int causal,
        void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    auto l = static_cast<const float*>(lse);
    auto d = static_cast<float*>(dsum);
    if (Dh == 64)
        return launch<64>(q, k, v, o, dout, l, d, dq, dk, dv, B, S, H, KVH,
                          causal, s);
    if (Dh == 128)
        return launch<128>(q, k, v, o, dout, l, d, dq, dk, dv, B, S, H, KVH,
                           causal, s);
    return (int)cudaErrorInvalidValue;
}
