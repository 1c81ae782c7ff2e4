// The backward of the flash attention kernel (flash_attention.cu):
// given q, k, v, the forward's per-row log-sum-exp lse and the output's
// gradient do, the gradients dq, dk and dv.
//
// Replaces the JAX package's autodiff of the attention its model path
// differentiates, src/repro/models/components.py:flash_attention (the
// jnp online softmax, rematerialised per layer): the TPU kernel
// src/repro/kernels/flash_attention/kernel.py has no backward.  It
// computes the analytic gradient of softmax(q k^T scale) v, with the
// forward's mask at q_offset 0 (key j visible to query i iff j < Skv
// and, if causal, j <= i and, under a window, j > i - window: the
// reference's flash_attention and its banded local_attention) and GQA
// (kv head h / G), Sq queries against Skv keys:
//
//     P  = exp(S scale - lse)                  (f32)
//     dP = do V^T
//     D  = rowsum(P * dP)                      (f32, per query row)
//     dV = sum over the G heads of P^T do
//     dS = P * (dP - D)
//     dQ = dS K scale,  dK = sum over the G heads of dS^T Q scale
//
// bf16 operands on the tensor cores (wgmma, f32 accumulation): P and dS
// are rounded to bf16 where they enter a product, as the forward rounds
// P before P V; dq, dk, dv are rounded to bf16 once, at the end.
//
// Deterministic by construction: no atomics, and every sum in an order
// fixed by the shapes.  Three kernels, launched in this order on one
// stream:
//   * flash_bwd_dq: one block per (64-row query tile, head, batch row),
//     issued longest walk first (block l takes query tile nq - 1 -
//     l / (H B) when causal).  It walks the key tiles (64 keys, anchored
//     at 0, as the forward) in ascending order from the tile of its
//     first row's window start up to the causal frontier twice.  The
//     first walk recomputes P and dP and sums D of its rows (each thread
//     its columns in a fixed order, then its row's 4-lane quad by two
//     xor shuffles), which it writes out for the second kernel; the
//     second recomputes P and dP, forms dS and accumulates dQ in
//     registers.
//   * flash_bwd_dkdv: one block per item of the plan (ops.plan_dkdv),
//     kv head and batch row, items longest first.  The walk of a key
//     tile runs the G query heads of its kv head in order and, for
//     each, the query tiles that can see it (ops.walk_bounds: from the
//     key tile's diagonal when causal, else from 0, to the last one
//     within the window), ascending.  A walk of more than C steps (C =
//     max(8, ceil(longest walk / 2)), from the shapes and the mask
//     only) is cut into runs of C steps, one block each, which write
//     their f32 partial dK and dV (64 keys x Dh each, unscaled) to a
//     workspace slot; a shorter walk is one block that keeps dK and dV
//     in registers and writes them as bf16 (a walk of no steps, a key
//     tile no query sees, writes zeros).
//   * flash_bwd_dkdv_combine (only when some walk was cut): one block
//     per cut walk adds its runs' partials from 0.0 in ascending run
//     order (__fadd_rn), scales dK, and rounds both to bf16 once.
// Each output element is written by exactly one thread, once.
//
// What bounds it on the H100: at S 2,048 (B 1, H 16, KVH 8, Dh 128)
// the tensor-core operations (0.043 ms of them); at qwen3's training
// shape (B 8, S 256) the bytes (0.013 ms) and the latency of a few
// tiles a block.  The first version of these kernels lost to three
// things, in this order: its products ran on mma.sync with ldmatrix
// operand traffic; the block of key tile 0 walked 64 steps alone where
// the mean walk was 33, and the dQ blocks came in index order, the
// longest last; every P took an IEEE expf, masked element by element.
// The design:
//
//   * wgmma.  A block is one warpgroup (four warps, 128 threads) on a
//     64-row tile: S (S^T in dkdv) and dP (dP^T) as m64n64k16 with both
//     operands K-major in shared memory; dQ += dS K, dV += P^T dO and
//     dK += dS^T Q as m64n{Dh}k16 with dS / P^T from registers (the
//     accumulator fragments packed to bf16 in place) and the other
//     operand read MN-major (transposed) from the same tiles.  Tiles sit
//     in shared memory in wgmma's 128-byte swizzle (64-column boxes),
//     filled by cp.async, double-buffered, made visible to the async
//     proxy by fence.proxy.async.  P is formed while the dP product is
//     still in flight (two commit groups).  dkdv holds dK and dV (128
//     f32 registers a thread at Dh 128) beside S^T and dP^T: 244
//     registers, no spill; dq 161.  Two blocks an SM (98 KB of shared
//     memory each at Dh 128).
//   * Balance: the run cut and longest-first issue above.
//   * P = 2^(S scale log2 e - lse log2 e) with one MUFU ex2 (relative
//     error ~2^-22), and tiles wholly inside S and the causal triangle
//     skip the element mask.
//
//   * Dh 256: dK and dV of 64 keys would take 256 f32 registers a thread
//     in one warpgroup.  A block is two warpgroups there (256 threads,
//     one block an SM, 193 KB of shared memory): both form the whole S
//     and dP (S^T and dP^T) over the 256 columns, and each accumulates
//     and writes one 128-column half of dQ (of dK and dV), the half of
//     the Q / dO / K tile it reads MN-major starting at box 2 h.  The
//     registers a thread are those of Dh 128; S and dP are formed twice
//     (6 products of the tile pair's size where 4 would do).
//
// S and dP are computed in both walks of the dQ kernel and again in the
// dK/dV kernel (9 products a tile pair where 5 suffice): without
// atomics, dQ's sum over key tiles and dK/dV's over query tiles need
// two kernels, and D needs a walk of its own.  D = rowsum(do * o), the
// usual shortcut, would read the output rounded to bf16: its error
// (~2^-9 of |o| a row) leaves dS rows that do not sum to zero, and
// where the keys (the queries) of a head share a large component, as
// the keys of whisper's decoder, which carry no rotary position, do at
// init, that residue lands on dQ and on dK's sum over keys, and so on
// Wq's and Wk's gradients.  The rowsum of the same P and dP that form
// dS (the reference's softmax gradient) keeps each row's sum at f32
// rounding.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W, L2 flushed
// before each call; device = the profiler's kernel time): 0.069 ms at
// B 8 x S 256 (device 0.059; SDPA's backward 0.099; bound 0.013 ms,
// bytes) and 0.255 ms at B 1 x S 2,048 (device 0.243; SDPA 0.210;
// bound 0.043 ms, operations).  The families' training shapes, device
// time: recurrentgemma's window 2,048 at Dh 256 and G 10 over B 1 x S
// 4,096, 1.354 ms (SDPA 2.513 wall; bound 0.163 ms, operations);
// whisper's cross-attention 64 x 1,500 keys, B 8, 0.074 ms, and its
// encoder B 8 x 1,500, 0.523 ms.
//
// Head dims 64, 128 and 256.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "attn_mma.cuh"

namespace {

using attn::cp_async16;
using attn::cp_async_commit;
using attn::cp_async_wait;
using attn::pack_bf16;

constexpr int TILE = 64;        // query rows / keys a tile (the forward's)
constexpr int WG = 128;         // threads of one warpgroup
constexpr int BOX = TILE * 128; // bytes of a 64-row x 64-column box

// warpgroups a block: two at Dh 256, each holding half of the block's
// output columns (see above)
__host__ __device__ constexpr int n_wg(int dh) { return dh > 128 ? 2 : 1; }

// Tiles in shared memory: 64 rows of DH bf16 as DH / 64 boxes of 64
// columns (BOX bytes apart); row r of a box at r * 128 bytes, its
// 16-byte chunk c at chunk position c ^ (r & 7): the layout wgmma's
// 128-byte swizzle reads, K-major or MN-major.  Byte offset of chunk c
// (0 .. DH / 8 - 1) of row r:
__device__ __forceinline__ uint32_t box(int r, int c) {
    return (uint32_t)((c >> 3) * BOX + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// rows [r0, r0 + 64) of a (rows, ld-apart) bf16 matrix into a tile; rows
// >= rows are zero.  All the block's threads take part.
template <int DH>
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const __nv_bfloat16* g,
                                          size_t ld, int r0, int rows) {
    constexpr int CH = DH / 8;
    for (int idx = threadIdx.x; idx < TILE * CH; idx += WG * n_wg(DH)) {
        const int r = idx / CH, c = idx % CH;
        const bool in = r0 + r < rows;
        const __nv_bfloat16* src = g + (in ? (size_t)(r0 + r) * ld : 0) + c * 8;
        cp_async16(dst + box(r, c), src, in ? 16 : 0);
    }
}

// 64-bit shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t sw128(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) |
           ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// a tile contracted over its DH columns (K-major), k16 step t: box
// t / 4, 32 bytes a step inside it, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int t) {
    return sw128(tile + (t >> 2) * BOX + (t & 3) * 32, 16, 1024);
}

// a tile contracted over its rows (MN-major: the DH columns are N), k16
// step t: rows 16 t .. 16 t + 15 of every box (BOX bytes apart)
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int t) {
    return sw128(tile + t * 16 * 128, BOX, 1024);
}

// keep the compiler from moving register reads/writes across the
// asynchronous wgmma (accumulators, and the A fragments it reads)
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int e = 0; e < N; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// 2^x (MUFU ex2, relative error ~2^-22): P = 2^(S scale log2 e - lse
// log2 e), the forward's exp with the log2 e folded into the operands
__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

constexpr float LOG2E = 1.4426950408889634f;

// cp.async writes (generic proxy) made visible to wgmma (async proxy)
__device__ __forceinline__ void proxy_fence() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x 64 f32) = a b (scale_d 0) or d + a b: a 64 x 16 and b 16 x 64
// bf16, both K-major in shared memory
__device__ __forceinline__ void mma_ss64(float (&d)[32], uint64_t a,
                                        uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64 f32) += a b: a 64 x 16 bf16 in registers (the warpgroup's
// fragments), b 16 x 64 bf16 MN-major in shared memory
__device__ __forceinline__ void mma_rs64(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128 f32) += a b: a 64 x 16 bf16 in registers (the warpgroup's
// fragments), b 16 x 128 bf16 MN-major in shared memory
__device__ __forceinline__ void mma_rs128(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// dst += a b over 64 contracted rows (4 k16 steps): a the warpgroup's
// bf16 fragments, b a tile read MN-major
template <int DH>
__device__ __forceinline__ void mma_rs_tile(float (&d)[DH / 2],
                                            const uint32_t (&a)[4][4],
                                            uint32_t tile) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
        if constexpr (DH == 128)
            mma_rs128(d, a[ks], mnmajor(tile, ks));
        else
            mma_rs64(d, a[ks], mnmajor(tile, ks));
    }
}

// d (64 x 64) = a b^T over DH: both tiles K-major
template <int DH>
__device__ __forceinline__ void mma_ss_tile(float (&d)[32], uint32_t a,
                                            uint32_t b) {
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks)
        mma_ss64(d, kmajor(a, ks), kmajor(b, ks), ks > 0);
}

template <int DH>
constexpr size_t dq_smem_bytes() {
    // 1 KB to align the tiles to the swizzle period; q tile, do tile,
    // then K and V tiles, double-buffered; all bf16
    return 1024 + (size_t)6 * TILE * DH * 2;
}

template <int DH>
constexpr size_t dkdv_smem_bytes() {
    // 1 KB of alignment; K and V tiles, (q, do) tile pairs
    // double-buffered, then lse and D of the two buffered query tiles
    return 1024 + (size_t)6 * TILE * DH * 2 + 4 * TILE * sizeof(float);
}

// the 1024-byte aligned start of the dynamic shared memory
__device__ __forceinline__ uint32_t smem_base(unsigned char* smem) {
    return ((uint32_t)__cvta_generic_to_shared(smem) + 1023u) & ~1023u;
}

// the forward's mask at q_offset 0: key j visible to query i
__device__ __forceinline__ bool visible(int i, int j, int Sq, int Skv,
                                        int causal, int window) {
    return i < Sq && j < Skv && (!causal || j <= i) &&
           (window <= 0 || j > i - window);
}

// every key of tile k0 visible to every query of tile q0 (no mask needed)
__device__ __forceinline__ bool whole_tile(int q0, int k0, int Sq, int Skv,
                                           int causal, int window) {
    return q0 + TILE <= Sq && k0 + TILE <= Skv &&
           (!causal || k0 + TILE <= q0) &&
           (window <= 0 || k0 > q0 + TILE - 1 - window);
}

// (first, last) query tile that can see key tile t: ops.walk_bounds
__device__ __forceinline__ int2 walk_bounds(int t, int nq, int causal,
                                            int window) {
    const int first = causal ? t : 0;
    const int last = window > 0
                         ? min(nq - 1, (t * TILE + TILE - 2 + window) / TILE)
                         : nq - 1;
    return make_int2(first, last);
}

template <int DH>
__global__ void __launch_bounds__(DH > 128 ? 2 * WG : WG, DH > 128 ? 1 : 2)
flash_bwd_dq(const __nv_bfloat16* __restrict__ q,    // (B,Sq,H,DH)
             const __nv_bfloat16* __restrict__ k,    // (B,Skv,KVH,DH)
             const __nv_bfloat16* __restrict__ v,
             const __nv_bfloat16* __restrict__ dout, // (B,Sq,H,DH)
             const float* __restrict__ lse,          // (B,H,Sq)
             float* __restrict__ dsum,               // (B,H,Sq) out: D
             __nv_bfloat16* __restrict__ dq,         // (B,Sq,H,DH)
             int B, int Sq, int Skv, int H, int KVH, int causal, int window,
             float scale) {
    constexpr int DO = DH / n_wg(DH);   // output columns a warpgroup
    constexpr int NO = DO / 8;
    constexpr int KT = TILE * DH * 2;   // bytes of one tile

    // longest walk first: block l takes query tile nq - 1 - l / (H B)
    // (causal; the walks are equal otherwise), head and row from l % (H B)
    const int nq = (Sq + TILE - 1) / TILE;
    const int step = blockIdx.x / (H * B), hb = blockIdx.x % (H * B);
    const int q0 = (causal ? nq - 1 - step : step) * TILE;
    const int h = hb % H;
    const int b = hb / H;
    const int kvh = h / (H / KVH);
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int wg = threadIdx.x / WG;    // this warpgroup's column half

    extern __shared__ __align__(128) unsigned char smem[];
    const uint32_t sq = smem_base(smem);
    const uint32_t sdo = sq + KT;
    const uint32_t sk = sdo + KT;        // 2 K tiles
    const uint32_t sv = sk + 2 * KT;     // 2 V tiles

    const size_t q_ld = (size_t)H * DH, kv_ld = (size_t)KVH * DH;
    const __nv_bfloat16* qb = q + ((size_t)b * Sq * H + h) * DH;
    const __nv_bfloat16* dob = dout + ((size_t)b * Sq * H + h) * DH;
    const __nv_bfloat16* kb = k + ((size_t)b * Skv * KVH + kvh) * DH;
    const __nv_bfloat16* vb = v + ((size_t)b * Skv * KVH + kvh) * DH;
    // the key tiles any row of the tile sees: from the tile of the first
    // row's window start to the causal frontier (none when kt1 <= kt0)
    const int kt0 = window > 0 ? max(0, q0 - window + 1) / TILE : 0;
    const int kt1 = ((causal ? min(Skv, q0 + TILE) : Skv) + TILE - 1) / TILE;
    const int ntiles = kt1 - kt0;

    load_rows<DH>(sq, qb, q_ld, q0, Sq);
    load_rows<DH>(sdo, dob, q_ld, q0, Sq);
    load_rows<DH>(sk, kb, kv_ld, kt0 * TILE, Skv);
    load_rows<DH>(sv, vb, kv_ld, kt0 * TILE, Skv);
    cp_async_commit();

    // this thread's rows (the accumulator layout of a warpgroup's 64
    // rows): r0 = q0 + 16 warp + lane / 4 and r0 + 8
    const int rq = warp * 16 + (lane >> 2);
    const int row0 = q0 + rq, row1 = row0 + 8;
    const size_t lrow = ((size_t)b * H + h) * Sq;

    const float l0 = row0 < Sq ? lse[lrow + row0] * LOG2E : 0.f;
    const float l1 = row1 < Sq ? lse[lrow + row1] * LOG2E : 0.f;
    const float sl2 = scale * LOG2E;

    float acc[NO * 4];
#pragma unroll
    for (int e = 0; e < NO * 4; ++e) acc[e] = 0.f;

    // walk 0 sums D of the two rows (d0, d1: this thread's columns, then
    // the quad's), walk 1 forms dS and accumulates dQ
    float d0 = 0.f, d1 = 0.f;
    for (int walk = 0; walk < 2; ++walk) {
        if (walk == 1 && ntiles > 0) {   // the first K and V tiles again
            load_rows<DH>(sk, kb, kv_ld, kt0 * TILE, Skv);
            load_rows<DH>(sv, vb, kv_ld, kt0 * TILE, Skv);
            cp_async_commit();
        }
        for (int t = 0; t < ntiles; ++t) {
            const int buf = t & 1;
            const int j0 = (kt0 + t) * TILE;
            if (t + 1 < ntiles) {
                load_rows<DH>(sk + (buf ^ 1) * KT, kb, kv_ld, j0 + TILE, Skv);
                load_rows<DH>(sv + (buf ^ 1) * KT, vb, kv_ld, j0 + TILE, Skv);
                cp_async_commit();
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            proxy_fence();
            __syncthreads();
            const uint32_t kt = sk + buf * KT, vt = sv + buf * KT;

            // S = Q K^T and dP = dO V^T: 64 rows x 64 keys, one warpgroup
            float s[32], dp[32];
#pragma unroll
            for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
            fence_regs(s);
            fence_regs(dp);
            wg_fence();
            mma_ss_tile<DH>(s, sq, kt);
            wg_commit();
            mma_ss_tile<DH>(dp, sdo, vt);
            wg_commit();

            // P = exp(S scale - lse) on the visible keys (while dP is in
            // flight); values e of n8 block n: row rq (+8 for e >= 2), key
            // 8 n + 2 (lane & 3) + (e & 1).  A tile wholly inside the mask
            // needs no element test.
            const bool whole = whole_tile(q0, j0, Sq, Skv, causal, window);
            wg_wait<1>();
            fence_regs(s);
            float pr[32];
#pragma unroll
            for (int n = 0; n < 8; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int j = j0 + 8 * n + 2 * (lane & 3) + (e & 1);
                    const int r = e < 2 ? row0 : row1;
                    const bool vis =
                        whole || visible(r, j, Sq, Skv, causal, window);
                    pr[4 * n + e] = vis ? exp2_approx(s[4 * n + e] * sl2 -
                                                      (e < 2 ? l0 : l1))
                                        : 0.f;
                }
            wg_wait<0>();
            fence_regs(dp);
            if (walk == 0) {
                // D += P dP over this thread's keys, in ascending order
#pragma unroll
                for (int n = 0; n < 8; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const float x = pr[4 * n + e] * dp[4 * n + e];
                        if (e < 2) d0 += x; else d1 += x;
                    }
                __syncthreads();   // the next prefetch's target
                continue;
            }
            // dS = P (dP - D), packed to bf16 A fragments (one per k16
            // step of 16 keys)
            uint32_t dsa[4][4];
#pragma unroll
            for (int n = 0; n < 8; ++n) {
                float ds[4];
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    ds[e] = pr[4 * n + e] *
                            (dp[4 * n + e] - (e < 2 ? d0 : d1));
                dsa[n >> 1][(n & 1) * 2] = pack_bf16(ds[0], ds[1]);
                dsa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
            }

            // dQ += dS K: this warpgroup's DO columns of K (keys x DH)
            // read MN-major
            fence_regs(acc);
            fence_frags(dsa);
            wg_fence();
            mma_rs_tile<DO>(acc, dsa, kt + wg * (DO / 64) * BOX);
            wg_commit();
            wg_wait<0>();
            fence_regs(acc);
            fence_frags(dsa);
            __syncthreads();   // this buffer is the next prefetch's target
        }
        if (walk == 0) {
            // the quad's four column sets, then written out (each
            // warpgroup alike; the first writes)
            d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
            d0 += __shfl_xor_sync(0xffffffffu, d0, 2);
            d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
            d1 += __shfl_xor_sync(0xffffffffu, d1, 2);
            if (wg == 0 && (lane & 3) == 0) {
                if (row0 < Sq) dsum[lrow + row0] = d0;
                if (row1 < Sq) dsum[lrow + row1] = d1;
            }
        }
    }

    const int col = wg * DO + 2 * (lane & 3);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int r = half ? row1 : row0;
        if (r >= Sq) continue;
        __nv_bfloat16* out = dq + (((size_t)b * Sq + r) * H + h) * DH + col;
#pragma unroll
        for (int n = 0; n < NO; ++n)
            *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) =
                __floats2bfloat162_rn(acc[4 * n + 2 * half] * scale,
                                      acc[4 * n + 2 * half + 1] * scale);
    }
}

template <int DH>
__global__ void __launch_bounds__(DH > 128 ? 2 * WG : WG, DH > 128 ? 1 : 2)
flash_bwd_dkdv(const __nv_bfloat16* __restrict__ q,    // (B,Sq,H,DH)
               const __nv_bfloat16* __restrict__ k,    // (B,Skv,KVH,DH)
               const __nv_bfloat16* __restrict__ v,
               const __nv_bfloat16* __restrict__ dout, // (B,Sq,H,DH)
               const float* __restrict__ lse,          // (B,H,Sq)
               const float* __restrict__ dsum,         // (B,H,Sq): D
               __nv_bfloat16* __restrict__ dk,         // (B,Skv,KVH,DH)
               __nv_bfloat16* __restrict__ dv,
               const int4* __restrict__ items,         // the plan
               float* __restrict__ ws,                 // run partials
               int B, int Sq, int Skv, int H, int KVH, int causal,
               int window, float scale) {
    constexpr int DO = DH / n_wg(DH);   // output columns a warpgroup
    constexpr int NO = DO / 8;
    constexpr int KT = TILE * DH * 2;

    // block l runs plan item l / (KVH B) (longest first) for kv head and
    // row l % (KVH B): key tile item.x, walk steps [item.y, item.z),
    // workspace slot item.w (-1: the whole walk, written as bf16 here)
    const int4 item = items[blockIdx.x / (KVH * B)];
    const int kb = blockIdx.x % (KVH * B);
    const int k0 = item.x * TILE;
    const int kvh = kb % KVH;
    const int b = kb / KVH;
    const int G = H / KVH;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int wg = threadIdx.x / WG;    // this warpgroup's column half

    extern __shared__ __align__(128) unsigned char smem[];
    const uint32_t sk = smem_base(smem);
    const uint32_t sv = sk + KT;
    const uint32_t sqd = sv + KT;        // 2 x (q tile, do tile)
    float* slse = reinterpret_cast<float*>(
        smem + (sk - (uint32_t)__cvta_generic_to_shared(smem)) + 6 * KT);
    float* sdd = slse + 2 * TILE;        // lse log2 e, then D: 2 x 64

    const size_t q_ld = (size_t)H * DH, kv_ld = (size_t)KVH * DH;
    const int nq = (Sq + TILE - 1) / TILE;
    const int2 wb = walk_bounds(item.x, nq, causal, window);
    const int qt0 = wb.x;                        // the walk's first tile
    const int per_head = max(1, wb.y - wb.x + 1);
    const int it0 = item.y, iters = item.z - item.y;

    // walk step it: head kvh G + it / per_head, query tile
    // qt0 + it % per_head, into buffer buf
    auto issue = [&](int it, int buf) {
        const int h = kvh * G + it / per_head;
        const int qs = (qt0 + it % per_head) * TILE;
        const size_t off = ((size_t)b * Sq * H + h) * DH;
        const uint32_t dst = sqd + buf * 2 * KT;
        load_rows<DH>(dst, q + off, q_ld, qs, Sq);
        load_rows<DH>(dst + KT, dout + off, q_ld, qs, Sq);
        if (threadIdx.x < 2 * TILE) {
            const bool is_lse = threadIdx.x < TILE;
            const int r = qs + (threadIdx.x & (TILE - 1));
            float* to = is_lse ? slse : sdd;
            to[buf * TILE + (threadIdx.x & (TILE - 1))] =
                r < Sq ? (is_lse ? lse : dsum)[((size_t)b * H + h) * Sq + r] *
                             (is_lse ? LOG2E : 1.f)
                       : 0.f;
        }
    };

    load_rows<DH>(sk, k + ((size_t)b * Skv * KVH + kvh) * DH, kv_ld, k0, Skv);
    load_rows<DH>(sv, v + ((size_t)b * Skv * KVH + kvh) * DH, kv_ld, k0, Skv);
    if (iters > 0) issue(it0, 0);
    cp_async_commit();

    // this thread's keys: kr0 = k0 + 16 warp + lane / 4 and kr0 + 8
    const int kr = warp * 16 + (lane >> 2);
    const int key0 = k0 + kr, key1 = key0 + 8;
    const float sl2 = scale * LOG2E;

    float adk[NO * 4], adv[NO * 4];
#pragma unroll
    for (int e = 0; e < NO * 4; ++e) adk[e] = adv[e] = 0.f;

    for (int i = 0; i < iters; ++i) {
        const int buf = i & 1;
        const int it = it0 + i;
        if (i + 1 < iters) {
            issue(it + 1, buf ^ 1);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        proxy_fence();
        __syncthreads();
        const uint32_t qt = sqd + buf * 2 * KT, dot = qt + KT;
        const float* tl = slse + buf * TILE;
        const float* td = sdd + buf * TILE;
        const int qs = (qt0 + it % per_head) * TILE;

        // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries
        float st[32], dpt[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) st[e] = dpt[e] = 0.f;
        fence_regs(st);
        fence_regs(dpt);
        wg_fence();
        mma_ss_tile<DH>(st, sk, qt);
        wg_commit();
        mma_ss_tile<DH>(dpt, sv, dot);
        wg_commit();

        // P^T (while dP^T is in flight), then dS^T: values e of n8 block
        // n are key kr (+8 for e >= 2), query qs + 8 n + 2 (lane & 3) +
        // (e & 1).  A tile pair wholly inside the mask needs no test.
        const bool whole = whole_tile(qs, k0, Sq, Skv, causal, window);
        wg_wait<1>();
        fence_regs(st);
        float pr[32];
        uint32_t pa[4][4], dsa[4][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int c = 8 * n + 2 * (lane & 3) + (e & 1);
                const int j = e < 2 ? key0 : key1;
                const bool vis =
                    whole || visible(qs + c, j, Sq, Skv, causal, window);
                pr[4 * n + e] =
                    vis ? exp2_approx(st[4 * n + e] * sl2 - tl[c]) : 0.f;
            }
        wg_wait<0>();
        fence_regs(dpt);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
            float ds[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int c = 8 * n + 2 * (lane & 3) + (e & 1);
                ds[e] = pr[4 * n + e] * (dpt[4 * n + e] - td[c]);
            }
            pa[n >> 1][(n & 1) * 2] = pack_bf16(pr[4 * n], pr[4 * n + 1]);
            pa[n >> 1][(n & 1) * 2 + 1] =
                pack_bf16(pr[4 * n + 2], pr[4 * n + 3]);
            dsa[n >> 1][(n & 1) * 2] = pack_bf16(ds[0], ds[1]);
            dsa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }

        // dV += P^T dO and dK += dS^T Q: this warpgroup's DO columns of
        // dO and Q (queries x DH) read MN-major
        fence_regs(adv);
        fence_regs(adk);
        fence_frags(pa);
        fence_frags(dsa);
        wg_fence();
        mma_rs_tile<DO>(adv, pa, dot + wg * (DO / 64) * BOX);
        mma_rs_tile<DO>(adk, dsa, qt + wg * (DO / 64) * BOX);
        wg_commit();
        wg_wait<0>();
        fence_regs(adv);
        fence_regs(adk);
        fence_frags(pa);
        fence_frags(dsa);
        __syncthreads();   // this buffer is the next prefetch's target
    }

    const int col = wg * DO + 2 * (lane & 3);
    if (item.w >= 0) {   // a run of a cut walk: f32, unscaled
        float* w = ws + (((size_t)item.w * B + b) * KVH + kvh) * 2 * TILE * DH;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const size_t row = (size_t)(kr + 8 * half) * DH + col;
#pragma unroll
            for (int n = 0; n < NO; ++n) {
                *reinterpret_cast<float2*>(w + row + 8 * n) = make_float2(
                    adk[4 * n + 2 * half], adk[4 * n + 2 * half + 1]);
                *reinterpret_cast<float2*>(w + TILE * DH + row + 8 * n) =
                    make_float2(adv[4 * n + 2 * half],
                                adv[4 * n + 2 * half + 1]);
            }
        }
        return;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int j = half ? key1 : key0;
        if (j >= Skv) continue;
        const size_t base = (((size_t)b * Skv + j) * KVH + kvh) * DH + col;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
            *reinterpret_cast<__nv_bfloat162*>(dk + base + 8 * n) =
                __floats2bfloat162_rn(adk[4 * n + 2 * half] * scale,
                                      adk[4 * n + 2 * half + 1] * scale);
            *reinterpret_cast<__nv_bfloat162*>(dv + base + 8 * n) =
                __floats2bfloat162_rn(adv[4 * n + 2 * half],
                                      adv[4 * n + 2 * half + 1]);
        }
    }
}

// dK and dV of a split walk: its chunks' f32 partials added from 0.0 in
// ascending chunk order (__fadd_rn), then dK scaled, both rounded to
// bf16 once.  Block (x, kvh, b) takes split x: key tile sp.x, whose
// sp.z chunks sit in workspace slots sp.y, sp.y + 1, ...
template <int DH>
__global__ void __launch_bounds__(256)
flash_bwd_dkdv_combine(const float* __restrict__ ws,
                       const int4* __restrict__ splits,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, int B, int Skv,
                       int KVH, float scale) {
    const int4 sp = splits[blockIdx.x];
    const int kvh = blockIdx.y, b = blockIdx.z;
    const size_t slot = (size_t)2 * TILE * DH;
    const float* w0 = ws + ((size_t)sp.y * B + b) * KVH * slot + kvh * slot;
    const size_t stride = (size_t)B * KVH * slot;   // from slot to slot
    for (int e = 2 * threadIdx.x; e < TILE * DH; e += 2 * blockDim.x) {
        const int j = sp.x * TILE + e / DH;
        if (j >= Skv) break;
        float2 ak = make_float2(0.f, 0.f), av = ak;
        for (int c = 0; c < sp.z; ++c) {
            const float2 pk = *reinterpret_cast<const float2*>(
                w0 + c * stride + e);
            const float2 pv = *reinterpret_cast<const float2*>(
                w0 + c * stride + TILE * DH + e);
            ak = make_float2(__fadd_rn(ak.x, pk.x), __fadd_rn(ak.y, pk.y));
            av = make_float2(__fadd_rn(av.x, pv.x), __fadd_rn(av.y, pv.y));
        }
        const size_t o = (((size_t)b * Skv + j) * KVH + kvh) * DH + e % DH;
        *reinterpret_cast<__nv_bfloat162*>(dk + o) =
            __floats2bfloat162_rn(ak.x * scale, ak.y * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + o) =
            __floats2bfloat162_rn(av.x, av.y);
    }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, float* dsum, void* dq, void* dk, void* dv,
           const int4* items, int n_items, const int4* splits,
           int n_splits, float* ws, int B, int Sq, int Skv, int H, int KVH,
           int causal, int window, cudaStream_t stream) {
    using bf = __nv_bfloat16;
    constexpr int NT = WG * n_wg(DH);
    const size_t s1 = dq_smem_bytes<DH>(), s2 = dkdv_smem_bytes<DH>();
    // at every launch: a function's attributes belong to the current
    // device's context, so a once-a-process setting would leave the
    // kernels unset on a second card
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)s1);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            flash_bwd_dkdv<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)s2);
    if (err != cudaSuccess) return (int)err;
    const float scale = 1.0f / sqrtf((float)DH);
    const int nq = (Sq + TILE - 1) / TILE;
    flash_bwd_dq<DH><<<nq * H * B, NT, s1, stream>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k),
        static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, dsum,
        static_cast<bf*>(dq), B, Sq, Skv, H, KVH, causal, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkdv<DH><<<n_items * KVH * B, NT, s2, stream>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k),
        static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, dsum,
        static_cast<bf*>(dk), static_cast<bf*>(dv), items, ws, B, Sq, Skv,
        H, KVH, causal, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess || n_splits == 0) return (int)err;
    flash_bwd_dkdv_combine<DH><<<dim3(n_splits, KVH, B), 256, 0, stream>>>(
        ws, splits, static_cast<bf*>(dk), static_cast<bf*>(dv), B, Skv, KVH,
        scale);
    return (int)cudaGetLastError();
}

}  // namespace

// q, dout, dq: (B, Sq, H, Dh); k, v, dk, dv: (B, Skv, KVH, Dh), all
// bf16 and contiguous; lse: the forward's (B, H, Sq) f32 log-sum-exp;
// dsum: an f32 (B, H, Sq) scratch buffer that receives D = rowsum(P *
// dP).  window: 0 for none.  items (n_items x int4) and splits
// (n_splits x int4): the dK/dV plan of ops.plan_dkdv on the device; ws:
// f32 scratch of n_slots x B x KVH x 2 x 64 x Dh floats (null when
// n_splits is 0).  Returns the cudaError_t of the launches (0 on
// success).
extern "C" int repro_flash_attention_bwd_bf16(
        const void* q, const void* k, const void* v, const void* dout,
        const void* lse, void* dsum, void* dq, void* dk, void* dv,
        const void* items, int n_items, const void* splits, int n_splits,
        void* ws, int B, int Sq, int Skv, int H, int KVH, int Dh,
        int causal, int window, void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    auto l = static_cast<const float*>(lse);
    auto d = static_cast<float*>(dsum);
    auto it = static_cast<const int4*>(items);
    auto sp = static_cast<const int4*>(splits);
    auto w = static_cast<float*>(ws);
    if (n_items < 1 || (n_splits > 0 && w == nullptr))
        return (int)cudaErrorInvalidValue;
    if (Dh == 64)
        return launch<64>(q, k, v, dout, l, d, dq, dk, dv, it, n_items,
                          sp, n_splits, w, B, Sq, Skv, H, KVH, causal,
                          window, s);
    if (Dh == 128)
        return launch<128>(q, k, v, dout, l, d, dq, dk, dv, it, n_items,
                           sp, n_splits, w, B, Sq, Skv, H, KVH, causal,
                           window, s);
    if (Dh == 256)
        return launch<256>(q, k, v, dout, l, d, dq, dk, dv, it, n_items,
                           sp, n_splits, w, B, Sq, Skv, H, KVH, causal,
                           window, s);
    return (int)cudaErrorInvalidValue;
}
