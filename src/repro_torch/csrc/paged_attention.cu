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
// 3.35 TB/s; at the serve path's sizes (B 8, ~300 keys) that is ~1.5
// us, so in practice the latency of each block's chain of loads.
// What the design does about it:
//  - Split over the keys.  One block of four warps per (b, kv head,
//    row group of <= 16 query rows (t, g), split of SPLIT = 128 keys
//    anchored at position 0): the grid is ceil(n * ps / SPLIT) splits
//    wide and a block past its row group's last key exits at once.  At
//    B 8 and ~300 keys that is ~110 working blocks instead of 64 blocks
//    each walking all keys alone.  Splits of 64 keys give more blocks
//    (~180) but half the bytes in flight a block and twice the partials
//    to combine; on the H100 they ran slower at the serve path's sizes
//    and at ~2,000-key contexts, and splits of 256 slower at the serve
//    path's sizes.
//  - One round of dependent loads.  The block reads its split's page
//    ids from the table once, together with the row's length (a pool
//    row per key, in shared memory), then issues every 16-byte cp.async
//    of its K/V tile at once, bf16,
//    into the XOR-swizzled layout of attn_mma.cuh; a split of more
//    than one tile double-buffers (the next tile loads while this one
//    is multiplied).  The T * G query rows of the GQA group share each
//    K/V tile, so K/V bytes are read once per kv head.
//  - Tensor cores.  The <= 16 query rows are one m16 tile: S = Q K^T
//    runs as mma.sync m16n8k16 (bf16 x bf16 -> f32), each warp taking
//    16 of the tile's 64 keys; P goes to shared memory as bf16 and
//    O += P V runs as mma.sync, each warp taking a quarter of Dh.
//  - Combining the splits.  A split writes its f32 partials (row max m,
//    denominator l, unnormalised output) to a workspace; the last block
//    of a (b, kv head, row group) to finish (a __threadfence and an
//    atomic ticket on a counter it then resets) combines them.  A row
//    group with one working split finishes from its registers.
//
// Summation structure (what makes the port's bitwise invariants hold):
// splits and tiles are anchored at position 0, independent of the page
// size, the table width, B and T.  Within a tile a row's max and sum
// are taken over each thread's four values in one fixed order, across
// the quad by xor shuffles (the same bits on all four lanes) and across
// the four warps in warp order; the products are elementwise and the
// same for every row position.  A row is combined over exactly the
// splits that hold at least one of its keys, in ascending split order:
// O = w_0 o_0 + w_1 o_1 + ..., L = w_0 l_0 + ..., w_s = exp(m_s - M),
// M the max of the m_s.  A split holding none of a row's keys has the
// row's m at -1e30 and exp(s - m) = 1 there (its l and o are sums of
// garbage), so it must never reach the row: the combine skips it, not
// relying on its weight exp(-1e30 - M) underflowing to 0.  With
// one split w_0 = 1 and the combine gives the bits of finishing from
// registers.  A row's bits therefore depend only on its own keys: the
// contiguous decode (the cache viewed as one page per row), the paged
// decode, a row alone and query t of a T-token call (== the one-token
// call at lengths + t) agree bit for bit, and the result does not
// depend on which block finishes last.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W, L2 flushed
// before each call): 0.0158 ms at B 8, T 5 and 0.0144 ms at T 1 (~300
// keys; SDPA over pre-gathered K/V 0.049 / 0.023 ms), 0.048 ms at T 5
// over ~2,000 keys against a 0.017 ms bound; the per-row-group design
// this replaces (synchronous loads into f32 shared memory, FMA
// products) took 0.0755 / 0.0468 / 0.459 ms.  112 registers a thread
// at Dh 128.  At Dh 256 (recurrentgemma's ring of 2,048 keys) the Q
// fragments take 64 registers and the K/V double buffer 128 KB of
// shared memory, so one block runs per SM with up to 255 registers a
// thread.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "attn_mma.cuh"

namespace {

using namespace attn;

constexpr int KV_TILE = 64;    // keys per online-softmax step
constexpr int SPLIT = 128;     // keys per block, anchored at position 0
constexpr int TILES = SPLIT / KV_TILE;
constexpr int NBUF = TILES > 1 ? 2 : 1;   // K/V buffers
constexpr int MAX_ROWS = 16;   // query rows (t, g) per block: one m16 tile
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;
static_assert(SPLIT % KV_TILE == 0 && 256 % SPLIT == 0,
              "SPLIT is 64, 128 or 256 keys");
constexpr int CHUNK = THREADS / MAX_ROWS;   // splits a combine pass reads
static_assert(KV_TILE == 16 * WARPS, "each warp takes 16 keys of a tile");

// shared-memory byte offsets: q rows at 0, then K tiles, V tiles and
// the P tile, all bf16
template <int DH> __host__ __device__ constexpr uint32_t k_off() {
    return MAX_ROWS * DH * 2;
}
template <int DH> __host__ __device__ constexpr uint32_t v_off() {
    return k_off<DH>() + NBUF * KV_TILE * DH * 2;
}
template <int DH> __host__ __device__ constexpr uint32_t p_off() {
    return v_off<DH>() + NBUF * KV_TILE * DH * 2;
}
template <int DH> __host__ __device__ constexpr size_t smem_bytes() {
    return p_off<DH>() + MAX_ROWS * KV_TILE * 2;
}

// the output of a row from its combined sums
__device__ __forceinline__ float finish(float o, float l) {
    return o / fmaxf(l, 1e-30f);
}

// one K/V tile into the swizzled tiles at dk and dv: key r < nkeys is
// pool row rows[r] (page * ps + slot), keys past nkeys are zero
template <int DH>
__device__ __forceinline__ void load_kv(uint32_t dk, uint32_t dv,
                                        const __nv_bfloat16* k_pages,
                                        const __nv_bfloat16* v_pages,
                                        const long long* rows, int nkeys,
                                        int KVH, int kvh) {
    constexpr int CH = DH / 8;
    for (int idx = threadIdx.x; idx < KV_TILE * CH; idx += THREADS) {
        const int r = idx / CH, c = idx % CH;
        const bool in = r < nkeys;
        const size_t off = in ? ((size_t)rows[r] * KVH + kvh) * DH + c * 8 : 0;
        cp_async16(dk + swz<DH>(r, c), k_pages + off, in ? 16 : 0);
        cp_async16(dv + swz<DH>(r, c), v_pages + off, in ? 16 : 0);
    }
    cp_async_commit();
}

template <int DH>
__global__ void __launch_bounds__(THREADS, DH > 128 ? 1 : 4)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,        // (B,T,H,DH)
                       const __nv_bfloat16* __restrict__ k_pages,  // (P,ps,KVH,DH)
                       const __nv_bfloat16* __restrict__ v_pages,
                       const int* __restrict__ tables,             // (B,n)
                       const int* __restrict__ lengths,            // (B,)
                       __nv_bfloat16* __restrict__ out,            // (B,T,H,DH)
                       float* __restrict__ ws,      // partials, see below
                       int* __restrict__ counters,  // one per group, zero
                       int T, int H, int KVH, int ps, int n, float scale) {
    constexpr int CH = DH / 8;            // 16-byte chunks of a row
    constexpr int KS = DH / 16;           // k16 steps of Q K^T
    constexpr int NW = DH / 8 / WARPS;    // n8 output tiles per warp
    constexpr int TILE = KV_TILE * DH * 2;

    const int s = blockIdx.x;             // key split
    const int kvh = blockIdx.y % KVH;
    const int r0 = (blockIdx.y / KVH) * MAX_ROWS;
    const int b = blockIdx.z;
    const int group = blockIdx.z * gridDim.y + blockIdx.y;
    const int G = H / KVH;
    const int rows = min(MAX_ROWS, T * G - r0);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    const int len = lengths[b];
    const int cover = n * ps;             // keys the table row covers
    const int j_begin = s * SPLIT;
    // the split's page ids do not depend on the lengths: read both at once
    constexpr int PER = (SPLIT + THREADS - 1) / THREADS;
    const int* tbl = tables + (size_t)b * n;
    int pid[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
        const int i = tid + u * THREADS, j = j_begin + i;
        pid[u] = i < SPLIT && j < cover ? tbl[j / ps] : 0;
    }
    // rows are in increasing t order: the last one reaches furthest
    const int kmax = min(len + (r0 + rows - 1) / G + 1, cover);
    const int nwork = (kmax + SPLIT - 1) / SPLIT;
    if (j_begin >= kmax) return;          // past the group's last key
    const int j_end = min(j_begin + SPLIT, kmax);
    const int ntile = (j_end - j_begin + KV_TILE - 1) / KV_TILE;

    extern __shared__ __align__(128) unsigned char smem[];
    const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
    const uint32_t sq = base, sk = base + k_off<DH>();
    const uint32_t sv = base + v_off<DH>(), sp = base + p_off<DH>();
    __shared__ long long s_row[SPLIT];    // pool row (page * ps + slot)
    __shared__ int s_limit[MAX_ROWS];     // keys row r attends
    __shared__ float red_m[WARPS][MAX_ROWS], red_l[WARPS][MAX_ROWS];
    __shared__ float s_w[MAX_ROWS][CHUNK], s_l[MAX_ROWS][CHUNK];
    __shared__ float s_L[MAX_ROWS];
    __shared__ int s_last;

    // the q rows (t, g) of this row group; rows past `rows` are zero
    for (int idx = tid; idx < MAX_ROWS * CH; idx += THREADS) {
        const int r = idx / CH, c = idx % CH;
        const int rr = r0 + (r < rows ? r : 0), t = rr / G, g = rr % G;
        cp_async16(sq + swz<DH>(r, c),
                   q + (((size_t)b * T + t) * H + kvh * G + g) * DH + c * 8,
                   r < rows ? 16 : 0);
    }
    cp_async_commit();
#pragma unroll
    for (int u = 0; u < PER; ++u) {
        const int i = tid + u * THREADS, j = j_begin + i;
        if (i < j_end - j_begin) s_row[i] = (long long)pid[u] * ps + j % ps;
    }
    if (tid < MAX_ROWS)
        s_limit[tid] = tid < rows ? min(len + (r0 + tid) / G + 1, cover) : 0;
    __syncthreads();

    load_kv<DH>(sk, sv, k_pages, v_pages, s_row, j_end - j_begin, KVH, kvh);

    // this thread's rows ra and rb = ra + 8 of the m16 tile
    const int ra = lane >> 2, rb = ra + 8;
    const int lim_a = s_limit[ra], lim_b = s_limit[rb];
    float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;
    float acc[NW][4];
#pragma unroll
    for (int i = 0; i < NW; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    uint32_t qf[KS][4];

    for (int i = 0; i < ntile; ++i) {
        const uint32_t buf = (uint32_t)(i & 1) * TILE;
        if (i + 1 < ntile) {
            const int k0 = (i + 1) * KV_TILE;
            load_kv<DH>(sk + (buf ^ TILE), sv + (buf ^ TILE), k_pages, v_pages,
                        s_row + k0, j_end - j_begin - k0, KVH, kvh);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        if (i == 0) {
#pragma unroll
            for (int ks = 0; ks < KS; ++ks)
                ldsm_x4(sq + swz<DH>(lane & 15, 2 * ks + (lane >> 4)), qf[ks]);
        }
        const uint32_t kt = sk + buf, vt = sv + buf;

        // S = Q K^T for this warp's 16 keys: two n8 tiles
        float sc[2][4];
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[nn][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
            uint32_t bk[4];
            const int m = lane >> 3;
            ldsm_x4(kt + swz<DH>(warp * 16 + (m >> 1) * 8 + (lane & 7),
                                 2 * ks + (m & 1)),
                    bk);
            mma(sc[0], qf[ks], bk[0], bk[1]);
            mma(sc[1], qf[ks], bk[2], bk[3]);
        }

        // scale and mask; sc[nn][0..1] are row ra, sc[nn][2..3] row rb,
        // key j0 + 16 warp + 8 nn + 2 (lane & 3) + e
        const int jw = j_begin + i * KV_TILE + warp * 16 + 2 * (lane & 3);
        float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int j = jw + 8 * nn + e;
                sc[nn][e] = j < lim_a ? sc[nn][e] * scale : NEG_INF;
                sc[nn][e + 2] = j < lim_b ? sc[nn][e + 2] * scale : NEG_INF;
                mx_a = fmaxf(mx_a, sc[nn][e]);
                mx_b = fmaxf(mx_b, sc[nn][e + 2]);
            }
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
        if ((lane & 3) == 0) {
            red_m[warp][ra] = mx_a;
            red_m[warp][rb] = mx_b;
        }
        __syncthreads();
        float mn_a = m_a, mn_b = m_b;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            mn_a = fmaxf(mn_a, red_m[w][ra]);
            mn_b = fmaxf(mn_b, red_m[w][rb]);
        }

        // p: the denominator sums f32 p; P V takes p rounded to bf16,
        // written to the P tile (64 keys a row, swizzled like K and V)
        float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
            const float p0 = expf(sc[nn][0] - mn_a), p1 = expf(sc[nn][1] - mn_a);
            const float p2 = expf(sc[nn][2] - mn_b), p3 = expf(sc[nn][3] - mn_b);
            ps_a += p0;
            ps_a += p1;
            ps_b += p2;
            ps_b += p3;
            const int c = 2 * warp + nn;
            const uint32_t col = 4 * (lane & 3);
            *reinterpret_cast<uint32_t*>(
                smem + p_off<DH>() + swz<KV_TILE>(ra, c) + col) =
                pack_bf16(p0, p1);
            *reinterpret_cast<uint32_t*>(
                smem + p_off<DH>() + swz<KV_TILE>(rb, c) + col) =
                pack_bf16(p2, p3);
        }
        ps_a += __shfl_xor_sync(0xffffffffu, ps_a, 1);
        ps_a += __shfl_xor_sync(0xffffffffu, ps_a, 2);
        ps_b += __shfl_xor_sync(0xffffffffu, ps_b, 1);
        ps_b += __shfl_xor_sync(0xffffffffu, ps_b, 2);
        if ((lane & 3) == 0) {
            red_l[warp][ra] = ps_a;
            red_l[warp][rb] = ps_b;
        }
        __syncthreads();
        float ts_a = red_l[0][ra], ts_b = red_l[0][rb];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) {
            ts_a += red_l[w][ra];
            ts_b += red_l[w][rb];
        }
        const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
        l_a = l_a * al_a + ts_a;
        l_b = l_b * al_b + ts_b;
        m_a = mn_a;
        m_b = mn_b;
#pragma unroll
        for (int nn = 0; nn < NW; ++nn) {
            acc[nn][0] *= al_a;
            acc[nn][1] *= al_a;
            acc[nn][2] *= al_b;
            acc[nn][3] *= al_b;
        }

        // O += P V for this warp's NW n8 tiles of Dh; V read transposed
#pragma unroll
        for (int ks = 0; ks < KV_TILE / 16; ++ks) {
            uint32_t pa[4];
            ldsm_x4(sp + swz<KV_TILE>(lane & 15, 2 * ks + (lane >> 4)), pa);
#pragma unroll
            for (int nn = 0; nn < NW; nn += 2) {
                uint32_t bv[4];
                ldsm_x4_t(vt + swz<DH>(ks * 16 + (lane & 15),
                                       warp * NW + nn + (lane >> 4)),
                          bv);
                mma(acc[nn], pa, bv[0], bv[1]);
                mma(acc[nn + 1], pa, bv[2], bv[3]);
            }
        }
        __syncthreads();   // the next prefetch's target, the P tile
    }

    // output element (row, d) of this group: row (t, g) = r0 + row
    auto out_at = [&](int r, int d) {
        const int rr = r0 + r, t = rr / G, g = rr % G;
        return out + (((size_t)b * T + t) * H + kvh * G + g) * DH + d;
    };
    const int col0 = warp * NW * 8 + 2 * (lane & 3);   // + 8 nn + {0, 1}
    if (nwork == 1) {   // the only split: finish from the registers
#pragma unroll
        for (int nn = 0; nn < NW; ++nn) {
            if (ra < rows)
                *reinterpret_cast<__nv_bfloat162*>(out_at(ra, col0 + 8 * nn)) =
                    __floats2bfloat162_rn(finish(acc[nn][0], l_a),
                                          finish(acc[nn][1], l_a));
            if (rb < rows)
                *reinterpret_cast<__nv_bfloat162*>(out_at(rb, col0 + 8 * nn)) =
                    __floats2bfloat162_rn(finish(acc[nn][2], l_b),
                                          finish(acc[nn][3], l_b));
        }
        return;
    }

    // workspace: for each group and split, MAX_ROWS x DH unnormalised
    // outputs, then (after all of them) MAX_ROWS maxima and MAX_ROWS
    // denominators
    const size_t n_part = (size_t)gridDim.x * gridDim.y * gridDim.z;
    float* w_acc = ws + (size_t)group * gridDim.x * MAX_ROWS * DH;
    float* w_ml = ws + n_part * MAX_ROWS * DH
                  + (size_t)group * gridDim.x * 2 * MAX_ROWS;
    {
        float* pa = w_acc + (size_t)s * MAX_ROWS * DH;
#pragma unroll
        for (int nn = 0; nn < NW; ++nn) {
            if (ra < rows)
                *reinterpret_cast<float2*>(pa + ra * DH + col0 + 8 * nn) =
                    make_float2(acc[nn][0], acc[nn][1]);
            if (rb < rows)
                *reinterpret_cast<float2*>(pa + rb * DH + col0 + 8 * nn) =
                    make_float2(acc[nn][2], acc[nn][3]);
        }
        float* pm = w_ml + (size_t)s * 2 * MAX_ROWS;
        if (warp == 0 && (lane & 3) == 0) {
            if (ra < rows) {
                pm[ra] = m_a;
                pm[MAX_ROWS + ra] = l_a;
            }
            if (rb < rows) {
                pm[rb] = m_b;
                pm[MAX_ROWS + rb] = l_b;
            }
        }
    }
    // the ticket: thread 0's fence releases the whole block's partials
    // (ordered before it by the barrier) and, after the atomic, acquires
    // the other blocks'
    __syncthreads();
    if (tid == 0) {
        __threadfence();
        s_last = atomicAdd(counters + group, 1) == nwork - 1;
        __threadfence();
    }
    __syncthreads();
    if (!s_last) return;
    if (tid == 0) counters[group] = 0;    // ready for the next launch

    // the last block combines row r over its splits 0 .. ns_r - 1 (the
    // ones that hold at least one of its keys) in ascending order, CHUNK
    // splits a pass: thread (cr, ci) loads split c0 + ci of row cr.
    // Partials are read from L2 (ld.cg), where the other blocks' writes
    // are.
    const int cr = tid / CHUNK, ci = tid % CHUNK;
    const int ns_c = cr < rows ? (s_limit[cr] + SPLIT - 1) / SPLIT : 0;
    float M = NEG_INF;                    // exact in any order
    float m_first = NEG_INF, l_first = 0.f;   // split ci, for the 1st pass
    if (ci < ns_c) {
        m_first = __ldcg(w_ml + (size_t)ci * 2 * MAX_ROWS + cr);
        l_first = __ldcg(w_ml + (size_t)ci * 2 * MAX_ROWS + MAX_ROWS + cr);
        M = m_first;
    }
    for (int i = ci + CHUNK; i < ns_c; i += CHUNK)
        M = fmaxf(M, __ldcg(w_ml + (size_t)i * 2 * MAX_ROWS + cr));
#pragma unroll
    for (int o = 1; o < CHUNK; o <<= 1)
        M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    // this thread's outputs: (row, 4 columns) tid + k THREADS
    constexpr int C4 = DH / 4, OUT = MAX_ROWS * C4 / THREADS;
    float4 o[OUT];
#pragma unroll
    for (int u = 0; u < OUT; ++u) o[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    float L = 0.f;                        // row cr's, in thread ci == 0
    for (int c0 = 0; c0 < nwork; c0 += CHUNK) {
        const int i = c0 + ci;
        float w = 0.f, l = 0.f;
        if (i < ns_c && c0 == 0) {
            w = expf(m_first - M);
            l = l_first;
        } else if (i < ns_c) {
            const float* pm = w_ml + (size_t)i * 2 * MAX_ROWS;
            w = expf(__ldcg(pm + cr) - M);
            l = __ldcg(pm + MAX_ROWS + cr);
        }
        s_w[cr][ci] = w;
        s_l[cr][ci] = l;
        __syncthreads();
        if (ci == 0)
            for (int k = 0; k < CHUNK && c0 + k < ns_c; ++k)
                L = c0 + k == 0 ? s_w[cr][k] * s_l[cr][k]
                                : L + s_w[cr][k] * s_l[cr][k];
#pragma unroll
        for (int u = 0; u < OUT; ++u) {
            const int r = (tid + u * THREADS) / C4;
            const int d = (tid + u * THREADS) % C4 * 4;
            const int ns = (s_limit[r] + SPLIT - 1) / SPLIT;
#pragma unroll
            for (int k = 0; k < CHUNK; ++k) {
                if (r >= rows || c0 + k >= ns) continue;
                const float4 a = __ldcg(reinterpret_cast<const float4*>(
                    w_acc + ((size_t)(c0 + k) * MAX_ROWS + r) * DH + d));
                const float wk = s_w[r][k];
                if (c0 + k == 0) {
                    o[u] = make_float4(wk * a.x, wk * a.y, wk * a.z, wk * a.w);
                } else {
                    o[u].x += wk * a.x;
                    o[u].y += wk * a.y;
                    o[u].z += wk * a.z;
                    o[u].w += wk * a.w;
                }
            }
        }
        __syncthreads();
    }
    if (ci == 0 && cr < rows) s_L[cr] = L;
    __syncthreads();
#pragma unroll
    for (int u = 0; u < OUT; ++u) {
        const int r = (tid + u * THREADS) / C4;
        const int d = (tid + u * THREADS) % C4 * 4;
        if (r >= rows) continue;
        const float Lr = s_L[r];
        __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(out_at(r, d));
        dst[0] = __floats2bfloat162_rn(finish(o[u].x, Lr), finish(o[u].y, Lr));
        dst[1] = __floats2bfloat162_rn(finish(o[u].z, Lr), finish(o[u].w, Lr));
    }
}

template <int DH>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* tables, const int* lengths, void* out, void* ws,
           void* counters, int B, int T, int H, int KVH, int ps, int n,
           cudaStream_t stream) {
    const size_t smem = smem_bytes<DH>();
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int G = H / KVH;
    const int groups = (T * G + MAX_ROWS - 1) / MAX_ROWS;
    dim3 grid((n * ps + SPLIT - 1) / SPLIT, KVH * groups, B);
    paged_attention_kernel<DH><<<grid, THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k_pages),
        static_cast<const __nv_bfloat16*>(v_pages), tables, lengths,
        static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws),
        static_cast<int*>(counters), T, H, KVH, ps, n,
        1.0f / sqrtf((float)DH));
    return (int)cudaGetLastError();
}

}  // namespace

// The key split the kernel was built with (the wrapper sizes the
// workspace and checks its own constant against it).
extern "C" int repro_paged_attention_split() { return SPLIT; }

// ws: (B * KVH * row groups * splits) * 16 * (Dh + 2) floats, splits =
// ceil(n * ps / SPLIT); counters: B * KVH * row groups ints, all zero
// (the kernel leaves them zero).  Returns the cudaError_t of the launch
// (0 on success).
extern "C" int repro_paged_attention_bf16(
        const void* q, const void* k_pages, const void* v_pages,
        const void* tables, const void* lengths, void* out, void* ws,
        void* counters, int B, int T, int H, int KVH, int Dh, int ps, int n,
        void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    auto tb = static_cast<const int*>(tables);
    auto ln = static_cast<const int*>(lengths);
    if (Dh == 64)
        return launch<64>(q, k_pages, v_pages, tb, ln, out, ws, counters, B,
                          T, H, KVH, ps, n, s);
    if (Dh == 128)
        return launch<128>(q, k_pages, v_pages, tb, ln, out, ws, counters, B,
                           T, H, KVH, ps, n, s);
    if (Dh == 256)
        return launch<256>(q, k_pages, v_pages, tb, ln, out, ws, counters, B,
                           T, H, KVH, ps, n, s);
    return (int)cudaErrorInvalidValue;
}
