// The bf16 tile pipeline of the dataflow GEMM (gemm_dataflow.cu) and
// the block-sparse GEMM (block_sparse.cu) on Hopper: TMA (or cp.async)
// fills a ring of shared-memory stages, two warpgroups run wgmma on it.
//
// Tile 128 x 128 x 128, as in tile_mma.cuh.  A block is 288 threads:
// warps 0-7 are two consumer warpgroups, each owning 64 x 128 of the C
// tile; warp 8 is the producer.  Shared memory holds a ring of STAGES
// A slots and STAGES B slots (32 KB each, bf16): 192 KB at STAGES = 3.
// A block walks a schedule of steps (i, j, kk) (Schedule below: OS,
// NR and block-sparse blocks are persistent, one per SM); as in the
// Pallas pipeline's copy-elision rule, an operand tile is fetched into
// its ring only when its index changed since the previous step, so the
// weight-stationary schedule keeps B(kk, j) resident in one B slot for
// its whole i sweep while A tiles stream through the A ring (and the
// input-stationary schedule the mirror).
//
// Slot layout (what TMA's 128-byte swizzle writes, and what wgmma's
// SW128 descriptors read): a 128 x 128 tile is two boxes of 128 rows x
// 64 elements; box h at h * 16 KB, row r at r * 128 bytes, its 16-byte
// chunk c at chunk position c ^ (r & 7).  A slot holds A(i, kk) with
// rows m and boxes k 0-63 / 64-127 (K-major); a B slot holds B(kk, j)
// with rows k and boxes n 0-63 / 64-127 (MN-major, the transpose bit).
//
// Producers.  TMA (cp.async.bulk.tensor.2d, one thread, completion on
// an mbarrier with the slot's byte count; out-of-bounds boxes are
// zero-filled by the hardware) when both operands have 16-byte aligned
// bases and row strides.  Otherwise the producer warp writes the same
// swizzled layout with cp.async (16-byte chunks whose source is 16-byte
// aligned, zero-filled past the edge) and element loads for the rest,
// then fences the writes into the async proxy and arrives on the same
// mbarrier.  The consumers do not know which producer ran: the bits are
// the same.
//
// What bounds it on the H100: the tensor cores at 989 TFLOP/s in
// principle; with one 128 x 128 x 128 tile per SM each 128-deep step
// reads 64 KB of operand tiles (mostly from L2) for 4.2 MFLOP, so at
// the scout expert GEMM (output-stationary 1.36-1.41 ms against a 0.69
// ms bound and 0.88 ms for torch.matmul; chip_smoke.py, NVIDIA H100
// 80GB HBM3, 700 W) the 10.7 GB of tile reads run at about 7.7 TB/s.
// Larger tiles per SM or TMA multicast across a cluster would cut
// them; the 128 tile is kept because the paper's dataflows, the
// traffic model and the bit contract are defined on it.
//
// The bit contract of tile_mma.cuh, kept: each 128-deep k tile is
// formed from zero by eight wgmma m64n128k16 steps in ascending k, the
// first with scale-d 0, then (after wgmma.wait_group 0) added to the
// running psum with one __fadd_rn per element, in registers (output-
// stationary, block-sparse) or in device memory (write_tile modes 1/2).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace pipe {

using bf16 = __nv_bfloat16;

constexpr int BM = tile::BM, BN = tile::BN, BK = tile::BK;
constexpr int CONSUMER_THREADS = 256;        // two warpgroups
constexpr int THREADS = CONSUMER_THREADS + 32;
constexpr int PRODUCER_WARP = CONSUMER_THREADS / 32;
constexpr int TILE_BYTES = BM * BK * 2;      // one bf16 tile, 32 KB
constexpr int BOX_BYTES = TILE_BYTES / 2;    // 128 rows x 64 elements
constexpr int BOX_COLS = 64;
constexpr int GROUP = 16;                    // rows of tiles per raster group

// Schedules: which (i, j, kk) a block visits, in order.
enum Flow { OS = 0, WS = 1, IS = 2, NR = 3, BS = 4 };

constexpr int STAGES = 3;                    // slots of each ring
// 1 KB of slack to align the rings to the 1024-byte swizzle period, the
// tiles, then the full and empty barriers of both rings
constexpr size_t SMEM =
    1024 + 2 * (size_t)STAGES * TILE_BYTES + 4 * STAGES * 8;

struct Args {
    const bf16* A;          // (M, K) row-major
    const bf16* B;          // (K, N) row-major
    float* C;               // (M, N) f32
    int M, N, K;
    const int* col_start;   // block-sparse jump table (BS only)
    const int* live_k;
    int kk;                 // the k step of a no-reuse launch (NR only)
    int use_tma;
};

// ------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
                 "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
                 : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(bytes)
        : "memory");
}

// A wait that never ends (a schedule bug) traps, which fails the launch
// on the host, instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    long long tries = 0;
    do {
        if (++tries > (1ll << 28)) __trap();
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
        : "memory");
}

// 64-bit shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) |
           ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// keeps the compiler from moving accumulator reads/writes across the
// asynchronous wgmma
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
    for (int e = 0; e < 64; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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
        : "l"(da), "l"(db), "r"(scale_d));
}

// ------------------------------------------------- the tile product
// The C layout the consumers leave in registers (wgmma's f32
// accumulator): pair p = (column group p >> 1, row half p & 1).
struct Wgmma {
    __device__ static __forceinline__ void pair_coord(int p, int& r, int& c) {
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
        r = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2) + 8 * (p & 1);
        c = 8 * (p >> 1) + 2 * (lane & 3);
    }
};

// Issue part = A_slot[64 wg .. 64 wg + 63, :] @ B_slot, formed from
// zero: eight k16 steps in ascending k, the first with scale-d 0, as
// one wgmma group; wait_product<N> waits until at most N groups are
// still in flight.  (Holding a second product in flight through the
// epilogue needs 64 more registers a thread: ptxas capped that version
// below it, with or without setmaxnreg; it spilled and ran slower.)
__device__ __forceinline__ void issue_product(float (&part)[64], uint32_t sa,
                                              uint32_t sb, int wg) {
    fence_operands(part);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
        // A, K-major: box t / 4, 32 bytes per k16 step inside the box,
        // 8-row groups 1024 bytes apart
        const uint64_t da = sw128_desc(
            sa + (t >> 2) * BOX_BYTES + wg * 64 * 128 + (t & 3) * 32, 16,
            1024);
        // B, MN-major: rows 16 t .. 16 t + 15 of both n boxes (16 KB
        // apart), 8-row groups 1024 bytes apart
        const uint64_t db = sw128_desc(sb + t * 16 * 128, BOX_BYTES, 1024);
        wgmma_m64n128k16(part, da, db, t > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    fence_operands(part);
}

template <int N>
__device__ __forceinline__ void wait_product(float (&part)[64]) {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
    fence_operands(part);
}

// ----------------------------------------------------- the schedule
// A step: tile product A(i, kk) @ B(kk, j) of C tile number `tile`; s
// is the block-sparse jump-table position.  kk < 0: no more steps.
struct Step {
    int i, j, kk, tile, s;
};
__device__ __forceinline__ Step done() { return {-1, -1, -1, -1, -1}; }

// Tile (i, j) of linear tile index t, in groups of GROUP rows of tiles
// (column by column inside a group) so the tiles in flight at once
// share A and B tiles in L2.  Bits do not depend on it.
__device__ __forceinline__ void raster(int t, int nm, int nn, int& i,
                                       int& j) {
    const int per = GROUP * nn, first = (t / per) * GROUP;
    const int rows = min(nm - first, GROUP), r = t % per;
    i = first + r % rows;
    j = r / rows;
}

// The steps of one block, in order.  OS, NR and BS blocks are
// persistent: block b owns tiles b, b + gridDim.x, ...
//   OS  all kk of a tile in ascending order, then the next tile.
//   NR  one kk (the launch's) of each tile.
//   BS  the live kk of the tile's column j in ascending order (the jump
//       table); a tile of a dead column has no step.
//   WS  column j = blockIdx.x: for kk, for i.      IS  the mirror.
template <int FLOW>
struct Schedule {
    int nm, nn, nk, tiles, kk_nr;
    const int* col_start;
    const int* live_k;

    __device__ explicit Schedule(const Args& a) {
        nm = (a.M + BM - 1) / BM;
        nn = (a.N + BN - 1) / BN;
        nk = (a.K + BK - 1) / BK;
        tiles = nm * nn;
        kk_nr = a.kk;
        col_start = a.col_start;
        live_k = a.live_k;
    }

    // the first step of this block's first tile at or after `tile`
    // that has one
    __device__ Step tile_first(int tile) const {
        for (; tile < tiles; tile += gridDim.x) {
            Step st{0, 0, FLOW == NR ? kk_nr : 0, tile, 0};
            raster(tile, nm, nn, st.i, st.j);
            if (FLOW != BS) return st;
            st.s = col_start[st.j];
            if (st.s < col_start[st.j + 1]) {
                st.kk = live_k[st.s];
                return st;
            }
        }
        return done();
    }

    __device__ Step first() const {
        if (FLOW == WS) return {0, (int)blockIdx.x, 0, 0, 0};
        if (FLOW == IS) return {(int)blockIdx.x, 0, 0, 0, 0};
        return tile_first(blockIdx.x);
    }

    __device__ Step next(const Step& c) const {
        if (FLOW == OS && c.kk + 1 < nk)
            return {c.i, c.j, c.kk + 1, c.tile, 0};
        if (FLOW == BS && c.s + 1 < col_start[c.j + 1])
            return {c.i, c.j, live_k[c.s + 1], c.tile, c.s + 1};
        if (FLOW == WS) {
            if (c.i + 1 < nm) return {c.i + 1, c.j, c.kk, 0, 0};
            return c.kk + 1 < nk ? Step{0, c.j, c.kk + 1, 0, 0} : done();
        }
        if (FLOW == IS) {
            if (c.j + 1 < nn) return {c.i, c.j + 1, c.kk, 0, 0};
            return c.kk + 1 < nk ? Step{c.i, 0, c.kk + 1, 0, 0} : done();
        }
        return tile_first(c.tile + gridDim.x);
    }
};

__device__ __forceinline__ bool a_changes(const Step& x, const Step& y) {
    return x.i != y.i || x.kk != y.kk;
}
__device__ __forceinline__ bool b_changes(const Step& x, const Step& y) {
    return x.kk != y.kk || x.j != y.j;
}

// ------------------------------------------------------ producers
// cp.async producer: rows [r0, r0 + 128) x cols [c0, c0 + 128) of g
// (rows x cols, row-major) into a slot in the swizzled layout, zeros
// outside the matrix.  All 32 lanes of the producer warp, BATCH chunks
// a lane at a time: a chunk whose source is 16-byte aligned goes by
// cp.async (zero-filled past the edge); the others are read element by
// element, all BATCH chunks' loads in flight before any is stored.
constexpr int BATCH = 4;

__device__ __forceinline__ void copy_tile(uint32_t slot, const bf16* g,
                                          int rows, int cols, int r0,
                                          int c0) {
    const int lane = threadIdx.x & 31;
    for (int first = lane; first < 128 * 16; first += 32 * BATCH) {
        uint32_t dst[BATCH], w[BATCH][4];
        bool by_hand[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
            const int idx = first + 32 * u;
            const int r = idx >> 4, c16 = idx & 15;
            dst[u] = slot + (c16 >> 3) * BOX_BYTES + r * 128 +
                     (((c16 & 7) ^ (r & 7)) << 4);
            const int gr = r0 + r, gc = c0 + c16 * 8;
            const int valid = gr < rows ? max(0, min(8, cols - gc)) : 0;
            const bf16* src = g + (size_t)gr * cols + gc;
            by_hand[u] = valid == 0 ||
                         (reinterpret_cast<uintptr_t>(src) & 15) != 0;
            if (!by_hand[u]) {
                asm volatile(
                    "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                        dst[u]),
                    "l"(src), "r"(valid * 2)
                    : "memory");
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const uint32_t lo =
                    by_hand[u] && 2 * q < valid
                        ? __bfloat16_as_ushort(src[2 * q]) : 0u;
                const uint32_t hi =
                    by_hand[u] && 2 * q + 1 < valid
                        ? __bfloat16_as_ushort(src[2 * q + 1]) : 0u;
                w[u][q] = lo | (hi << 16);
            }
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u)
            if (by_hand[u])
                asm volatile(
                    "st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst[u]),
                    "r"(w[u][0]), "r"(w[u][1]), "r"(w[u][2]), "r"(w[u][3])
                    : "memory");
    }
}

// Fill `slot` with tile (r0, c0) of an operand and signal `full`.
__device__ __forceinline__ void fill(uint32_t slot, uint32_t full,
                                     const CUtensorMap* map, const bf16* g,
                                     int rows, int cols, int r0, int c0,
                                     bool use_tma) {
    if (use_tma) {
        if ((threadIdx.x & 31) == 0) {
            mbar_expect_tx(full, TILE_BYTES);
            tma_load_2d(slot, map, c0, r0, full);
            tma_load_2d(slot + BOX_BYTES, map, c0 + BOX_COLS, r0, full);
        }
    } else {
        copy_tile(slot, g, rows, cols, r0, c0);
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        // generic-proxy writes, read next by wgmma (async proxy)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(full);
    }
}

// ------------------------------------------------------- the kernel
// One block: the producer warp fetches each step's new operand tiles
// into the rings; the consumers form each step's tile product and add
// it to the psum, in registers (OS, BS: C written once) or through C
// (WS, IS, NR: mode 1 at kk = 0, mode 2 after).
template <int FLOW>
__global__ void __launch_bounds__(THREADS, 1)
gemm_bf16(const __grid_constant__ CUtensorMap map_a,
          const __grid_constant__ CUtensorMap map_b, const Args args) {
    extern __shared__ unsigned char smem_raw[];
    const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
    const uint32_t ring_a = base;
    const uint32_t ring_b = base + STAGES * TILE_BYTES;
    const uint32_t bars = ring_b + STAGES * TILE_BYTES;
    // full_a, empty_a, full_b, empty_b: STAGES barriers each
    auto bar = [&](int kind, int slot) {
        return bars + (kind * STAGES + slot) * 8;
    };
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(bar(0, s), args.use_tma ? 1 : 32);
            mbar_init(bar(1, s), CONSUMER_THREADS / 32);
            mbar_init(bar(2, s), args.use_tma ? 1 : 32);
            mbar_init(bar(3, s), CONSUMER_THREADS / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const Schedule<FLOW> sch(args);

    if (warp == PRODUCER_WARP) {
        Step prev = done();
        int na = 0, nb = 0;
        for (Step cur = sch.first(); cur.kk >= 0; cur = sch.next(cur)) {
            if (a_changes(cur, prev)) {
                const int slot = na % STAGES;
                mbar_wait(bar(1, slot), ((na / STAGES) & 1) ^ 1);
                fill(ring_a + slot * TILE_BYTES, bar(0, slot), &map_a,
                     args.A, args.M, args.K, cur.i * BM, cur.kk * BK,
                     args.use_tma);
                ++na;
            }
            if (b_changes(cur, prev)) {
                const int slot = nb % STAGES;
                mbar_wait(bar(3, slot), ((nb / STAGES) & 1) ^ 1);
                fill(ring_b + slot * TILE_BYTES, bar(2, slot), &map_b,
                     args.B, args.K, args.N, cur.kk * BK, cur.j * BN,
                     args.use_tma);
                ++nb;
            }
            prev = cur;
        }
        return;
    }

    // consumers
    const int wg = warp >> 2;
    float acc[64], part[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = part[e] = 0.f;
    // block-sparse: the next of this block's tiles not yet written; the
    // tiles of dead columns that the schedule skips are written as
    // exact zeros (acc is zero whenever they are)
    int unwritten = blockIdx.x;
    auto zero_tiles_before = [&](int tile) {
        for (; unwritten < tile; unwritten += gridDim.x) {
            int i, j;
            raster(unwritten, sch.nm, sch.nn, i, j);
            tile::write_tile<Wgmma>(args.C, args.M, args.N, i, j, acc, 0);
        }
    };
    Step prev = done(), cur = sch.first();
    int na = -1, nb = -1;
    while (cur.kk >= 0) {
        if (FLOW == BS) zero_tiles_before(cur.tile);
        if (a_changes(cur, prev)) {
            ++na;
            mbar_wait(bar(0, na % STAGES), (na / STAGES) & 1);
        }
        if (b_changes(cur, prev)) {
            ++nb;
            mbar_wait(bar(2, nb % STAGES), (nb / STAGES) & 1);
        }
        __syncwarp();
        issue_product(part, ring_a + (na % STAGES) * TILE_BYTES,
                      ring_b + (nb % STAGES) * TILE_BYTES, wg);
        const Step next = sch.next(cur);
        wait_product<0>(part);
        // hand a slot back once no later step of this block reads it
        __syncwarp();
        if (lane == 0) {
            if (a_changes(next, cur)) mbar_arrive(bar(1, na % STAGES));
            if (b_changes(next, cur)) mbar_arrive(bar(3, nb % STAGES));
        }
        if (FLOW == OS || FLOW == BS) {
            tile::accumulate(acc, part);
            if (next.tile != cur.tile) {
                tile::write_tile<Wgmma>(args.C, args.M, args.N, cur.i,
                                        cur.j, acc, 0);
#pragma unroll
                for (int e = 0; e < 64; ++e) acc[e] = 0.f;
                unwritten = cur.tile + gridDim.x;
            }
        } else {
            tile::write_tile<Wgmma>(args.C, args.M, args.N, cur.i, cur.j,
                                    part, cur.kk == 0 ? 1 : 2);
        }
        prev = cur;
        cur = next;
    }
    if (FLOW == BS) zero_tiles_before(sch.tiles);
}

// ------------------------------------------------------------ host
// TMA needs 16-byte aligned bases and row strides; the wrapper chooses
// the producer from the same rule and this refuses a TMA request that
// breaks it.
inline bool tma_ok(const Args& a) {
    return (reinterpret_cast<uintptr_t>(a.A) & 15) == 0 &&
           (reinterpret_cast<uintptr_t>(a.B) & 15) == 0 && a.K % 8 == 0 &&
           a.N % 8 == 0;
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime
// (cudaGetDriverEntryPointByVersion), so nothing links against libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
        cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// A (rows x cols) bf16 row-major matrix as 128 x 64 boxes, 128-byte
// swizzle, zeros out of bounds.
inline bool encode(CUtensorMap* map, const bf16* g, int rows, int cols) {
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return false;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
    const cuuint32_t box[2] = {BOX_COLS, 128};
    const cuuint32_t elem[2] = {1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
              const_cast<bf16*>(g), dims, strides, box, elem,
              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Tensor maps of one call's operands (zeroed, unused, for cp.async).
inline cudaError_t maps_for(const Args& a, CUtensorMap* ma, CUtensorMap* mb) {
    *ma = CUtensorMap{};
    *mb = CUtensorMap{};
    if (!a.use_tma) return cudaSuccess;
    if (!tma_ok(a)) return cudaErrorInvalidValue;
    if (!encode(ma, a.A, a.M, a.K) || !encode(mb, a.B, a.K, a.N))
        return cudaErrorInvalidValue;
    return cudaSuccess;
}

// the current device's SM count, read once a device (cards of one
// process may differ)
inline int sm_count() {
    constexpr int MAX_DEVICES = 64;
    static int counts[MAX_DEVICES] = {};
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 1;
    if (dev < MAX_DEVICES && counts[dev] > 0) return counts[dev];
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n < 1)
        n = 1;
    if (dev < MAX_DEVICES) counts[dev] = n;
    return n;
}

// OS, NR and BS blocks are persistent (one per SM, each walking tiles
// gridDim.x apart); WS and IS launch the blocks their schedule names.
template <int FLOW>
cudaError_t launch(const Args& a, const CUtensorMap& ma,
                   const CUtensorMap& mb, int blocks, cudaStream_t stream) {
    if (FLOW == OS || FLOW == NR || FLOW == BS)
        blocks = blocks < sm_count() ? blocks : sm_count();
    cudaError_t err = cudaFuncSetAttribute(
        gemm_bf16<FLOW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM);
    if (err != cudaSuccess) return err;
    gemm_bf16<FLOW><<<blocks, THREADS, SMEM, stream>>>(ma, mb, a);
    return cudaGetLastError();
}

}  // namespace pipe
