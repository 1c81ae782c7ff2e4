// The output-stationary f32 product of the dataflow GEMM
// (gemm_dataflow.cu, dataflow 0 with float32 operands): C = A @ B, A
// (M, K) and B (K, N) row-major f32, C (M, N) f32, off the tensor cores
// (f32 FMAs, no TF32).
//
// The bit contract of tile_mma.cuh, unchanged: for every 128-deep k
// tile, each output element is one chain of fmaf from 0.0 over k
// ascending (128 steps, zeros past K), and the chains are added to the
// psum in ascending k with one __fadd_rn each, the psum starting at
// 0.0.  No tile shape, thread mapping or split below changes an
// operation of that sequence, so this kernel gives the bits of the FMA
// tile product (Mma<float>) that the other three dataflows and the
// block-sparse kernel keep.
//
// What bounds it on the H100: the f32 FMA rate (67 TFLOP/s) at large M
// (recurrentgemma's 16,384-row prefill through RG-LRU's 2560 x 2560
// gates), device memory (3.35 TB/s) at decode sizes, where the weight
// is read once for 8 rows.  What the design does about it:
//
//   * Pipelined staging.  Each 128-deep k tile is staged as four
//     32-deep sub-tiles (A BM x 32, B 32 x BN) through a ring of STAGES
//     buffers filled by cp.async (16-byte copies where the operand's
//     rows allow, 4-byte ones with zero fill at ragged edges), so the
//     copies of the next sub-tiles run under the FMAs of this one.  A
//     block holds at most 32 outputs a thread (a psum and a k-tile
//     product each: at most 128 registers) and 80 KB of shared memory,
//     so two blocks share an SM; a 128 x 128 tile would need the whole
//     SM for one block.
//   * A tile chosen from the shape.  BM is 8, 16, 32, 64 or 128 rows
//     and BN 64 or 128 columns, 128 only with BM <= 64 (ops.plan_f32);
//     a 256-thread block is a
//     TY x TX grid (TY = min(BM, 16)), thread (ty, tx) owning rows ty +
//     TY r and VEC (4, or 2 where the tile is too narrow) adjacent
//     columns from VEC (tx + TX c), read from shared memory as one
//     vector, so at M 8 no FMA falls on a row the shape does not have.
//   * A split over whole k tiles when the output tiles leave most SMs
//     idle (a router's N 16 is one tile): grid z runs over chunks of
//     tiles_per_chunk consecutive k tiles; each block writes every k
//     tile's product, formed from zero, to the f32 workspace ws (nk x M
//     x N), and a second launch (gemm_f32_combine) adds the nk products
//     of each element into C from 0.0 in ascending k with __fadd_rn.
//     Without a split the block keeps the psum in registers and writes
//     C once.  The plan caps the workspace (64 MB), so a large product
//     does not split.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W, L2 flushed
// before each call): 1000 x 5120 x 1000 0.37-0.43 ms (the FMA tile
// product of tile_mma.cuh, which this replaces for OUTPUT_STATIONARY,
// 0.95; torch.matmul 0.25; bound 0.153); RG-LRU's 2560 x 2560 at
// M 16,384 6.16 ms (10.14; torch.matmul 4.52); the routers and gates
// at M 8 0.010-0.028 ms, 0.84-1.68x torch.matmul by kernel time (up to
// 0.83 ms before: one block walked every k tile).  What still holds it
// back: under 40 % of the FFMA peak at 1000 x 1000 (128 blocks of
// 128 x 64 on 132 SMs, one wave), and a 64-column tile for a router's
// 16 columns.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace f32os {

constexpr int BK = 128;        // the contract's k tile
constexpr int SUB = 32;        // k depth of one pipeline stage
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int LDA = SUB + 4;   // A rows padded: 16-byte aligned, and the
                               // two rows a warp reads sit 4 banks apart

template <int BM, int BN>
struct Shape {
    static constexpr int TY = BM < 16 ? BM : 16;
    static constexpr int TX = THREADS / TY;
    static constexpr int RM = BM / TY;            // rows a thread
    static constexpr int VEC = BN >= 4 * TX ? 4 : 2;   // adjacent columns
    static constexpr int CN = BN / (VEC * TX);    // column groups a thread
    static constexpr int OUT = VEC * RM * CN;     // outputs a thread
    static constexpr int STAGE_FLOATS = BM * LDA + SUB * BN;
    static constexpr size_t SMEM = sizeof(float) * STAGES * STAGE_FLOATS;
    static_assert(TY * RM == BM && VEC * TX * CN == BN && CN >= 1,
                  "tile does not map onto 256 threads");
    static_assert(OUT <= 32, "two blocks an SM: at most 128 registers");
};

__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void cp4(uint32_t dst, const void* src,
                                    int bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_group() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + R) x cols [c0, c0 + C) of the row-major g (rows x
// cols, leading dimension = cols) into shared memory at dst (row
// stride LD floats), zeros outside g; vec: g's rows allow 16-byte copies
template <int R, int C, int LD>
__device__ __forceinline__ void stage(uint32_t dst, const float* g, int rows,
                                      int cols, int r0, int c0, bool vec) {
    constexpr int CH = C / 4;
    for (int idx = threadIdx.x; idx < R * CH; idx += THREADS) {
        const int r = idx / CH, c = (idx % CH) * 4;
        const int gr = r0 + r, gc = c0 + c;
        const uint32_t d = dst + (uint32_t)(r * LD + c) * 4u;
        const float* src = g + (size_t)gr * cols + gc;
        if (gr >= rows) {
            cp16(d, g, 0);
        } else if (vec && gc + 4 <= cols) {
            cp16(d, src, 16);
        } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const bool in = gc + e < cols;
                cp4(d + 4u * e, in ? src + e : g, in ? 4 : 0);
            }
        }
    }
}

// the thread's outputs of tile (i, j): group (r, c) at row i BM + ty +
// TY r, columns j BN + VEC (tx + TX c) + {0 .. VEC - 1}
template <int BM, int BN>
__device__ __forceinline__ void store(float* __restrict__ C, int M, int N,
                                      int i, int j,
                                      const float (&v)[Shape<BM, BN>::OUT]) {
    using S = Shape<BM, BN>;
    constexpr int VEC = S::VEC;
    const int ty = threadIdx.x / S::TX, tx = threadIdx.x % S::TX;
    const bool vec_ok = (N % VEC == 0) &&
                        ((reinterpret_cast<uintptr_t>(C) & (4 * VEC - 1)) ==
                         0);
#pragma unroll
    for (int r = 0; r < S::RM; ++r) {
        const int row = i * BM + ty + S::TY * r;
        if (row >= M) continue;
#pragma unroll
        for (int c = 0; c < S::CN; ++c) {
            const int col = j * BN + VEC * (tx + S::TX * c);
            float* dst = C + (size_t)row * N + col;
            const float* x = v + (r * S::CN + c) * VEC;
            if (vec_ok && col + VEC <= N) {
                if constexpr (VEC == 4)
                    *reinterpret_cast<float4*>(dst) =
                        make_float4(x[0], x[1], x[2], x[3]);
                else
                    *reinterpret_cast<float2*>(dst) = make_float2(x[0], x[1]);
            } else {
#pragma unroll
                for (int e = 0; e < VEC; ++e)
                    if (col + e < N) dst[e] = x[e];
            }
        }
    }
}

// C (ws == nullptr) or the workspace slots of k tiles [z T, z T + T)
// (ws != nullptr) for output tile (blockIdx.y, blockIdx.x)
template <int BM, int BN>
__global__ void __launch_bounds__(THREADS, 2)
gemm_f32_os(const float* __restrict__ A, const float* __restrict__ B,
            float* __restrict__ C, float* __restrict__ ws, int M, int N,
            int K, int tiles_per_chunk) {
    using S = Shape<BM, BN>;
    extern __shared__ __align__(16) float f32os_smem[];
    float* smem = f32os_smem;
    const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
    const int j = blockIdx.x, i = blockIdx.y;
    const int nk = (K + BK - 1) / BK;
    const int kt0 = blockIdx.z * tiles_per_chunk;
    const int kt1 = min(nk, kt0 + tiles_per_chunk);
    const int nsub = (kt1 - kt0) * (BK / SUB);
    const bool vec_a = (K % 4 == 0) &&
                       ((reinterpret_cast<uintptr_t>(A) & 15) == 0);
    const bool vec_b = (N % 4 == 0) &&
                       ((reinterpret_cast<uintptr_t>(B) & 15) == 0);
    const int ty = threadIdx.x / S::TX, tx = threadIdx.x % S::TX;

    auto load = [&](int s) {
        const uint32_t dst = base + 4u * (s % STAGES) * S::STAGE_FLOATS;
        const int k0 = kt0 * BK + s * SUB;
        stage<BM, SUB, LDA>(dst, A, M, K, i * BM, k0, vec_a);
        stage<SUB, BN, BN>(dst + 4u * BM * LDA, B, K, N, k0, j * BN, vec_b);
    };

    float acc[S::OUT], part[S::OUT];
#pragma unroll
    for (int e = 0; e < S::OUT; ++e) acc[e] = part[e] = 0.f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nsub) load(s);
        commit();
    }
    for (int s = 0; s < nsub; ++s) {
        wait_group<STAGES - 2>();
        __syncthreads();   // stage s landed; stage s - 1 is free
        if (s + STAGES - 1 < nsub) load(s + STAGES - 1);
        commit();
        const float* sA = smem + (s % STAGES) * S::STAGE_FLOATS;
        const float* sB = sA + BM * LDA;
#pragma unroll 2
        for (int k4 = 0; k4 < SUB; k4 += 4) {
            float4 a[S::RM];
#pragma unroll
            for (int r = 0; r < S::RM; ++r)
                a[r] = *reinterpret_cast<const float4*>(
                    sA + (ty + S::TY * r) * LDA + k4);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                float b[S::CN][S::VEC];
#pragma unroll
                for (int c = 0; c < S::CN; ++c) {
                    const float* src =
                        sB + (k4 + kk) * BN + S::VEC * (tx + S::TX * c);
                    if constexpr (S::VEC == 4) {
                        const float4 t = *reinterpret_cast<const float4*>(src);
                        b[c][0] = t.x; b[c][1] = t.y;
                        b[c][2] = t.z; b[c][3] = t.w;
                    } else {
                        const float2 t = *reinterpret_cast<const float2*>(src);
                        b[c][0] = t.x; b[c][1] = t.y;
                    }
                }
#pragma unroll
                for (int r = 0; r < S::RM; ++r) {
                    const float av = kk == 0 ? a[r].x : kk == 1 ? a[r].y
                                   : kk == 2 ? a[r].z : a[r].w;
#pragma unroll
                    for (int c = 0; c < S::CN; ++c) {
                        float* d = part + (r * S::CN + c) * S::VEC;
#pragma unroll
                        for (int e = 0; e < S::VEC; ++e)
                            d[e] = fmaf(av, b[c][e], d[e]);
                    }
                }
            }
        }
        if ((s & 3) == 3) {   // a whole 128-deep k tile
            if (ws != nullptr) {
                const int kt = kt0 + (s >> 2);
                store<BM, BN>(ws + (size_t)kt * M * N, M, N, i, j, part);
            } else {
#pragma unroll
                for (int e = 0; e < S::OUT; ++e)
                    acc[e] = __fadd_rn(acc[e], part[e]);
            }
#pragma unroll
            for (int e = 0; e < S::OUT; ++e) part[e] = 0.f;
        }
    }
    wait_group<0>();
    if (ws == nullptr) store<BM, BN>(C, M, N, i, j, acc);
}

// C = sum over k tiles of ws[kt], from 0.0, ascending, one __fadd_rn each
__global__ void __launch_bounds__(256)
gemm_f32_combine(const float* __restrict__ ws, float* __restrict__ C,
                 size_t mn, int nk) {
    for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < mn;
         e += (size_t)gridDim.x * blockDim.x) {
        float acc = 0.f;
#pragma unroll 8
        for (int kt = 0; kt < nk; ++kt)
            acc = __fadd_rn(acc, ws[(size_t)kt * mn + e]);
        C[e] = acc;
    }
}

template <int BM, int BN>
cudaError_t launch_tile(const float* A, const float* B, float* C, float* ws,
                        int M, int N, int K, int tiles_per_chunk,
                        cudaStream_t stream) {
    using S = Shape<BM, BN>;
    // at every launch: a function's attributes belong to the current
    // device's context, so a once-a-process setting would leave the
    // kernel unset on a second card
    cudaError_t err = cudaFuncSetAttribute(
        gemm_f32_os<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)S::SMEM);
    if (err != cudaSuccess) return err;
    const int nk = (K + BK - 1) / BK;
    const int chunks = (nk + tiles_per_chunk - 1) / tiles_per_chunk;
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, chunks);
    gemm_f32_os<BM, BN><<<grid, THREADS, S::SMEM, stream>>>(
        A, B, C, chunks > 1 ? ws : nullptr, M, N, K, tiles_per_chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess || chunks == 1) return err;
    const size_t mn = (size_t)M * N;
    const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256
                                                      : 4096);
    gemm_f32_combine<<<blocks, 256, 0, stream>>>(ws, C, mn, nk);
    return cudaGetLastError();
}

// the plan of ops.plan_f32: bm in {8, 16, 32, 64, 128}, bn in {64, 128}
// (128 only with bm <= 64), tiles_per_chunk >= 1 (a workspace of nk M N
// floats when it is < nk)
inline cudaError_t launch(const float* A, const float* B, float* C,
                          float* ws, int M, int N, int K, int bm, int bn,
                          int tiles_per_chunk, cudaStream_t stream) {
    const int nk = (K + BK - 1) / BK;
    if (tiles_per_chunk < 1 || (tiles_per_chunk < nk && ws == nullptr))
        return cudaErrorInvalidValue;
#define F32OS_CASE(m, n)                                                    \
    if (bm == m && bn == n)                                                 \
        return launch_tile<m, n>(A, B, C, ws, M, N, K, tiles_per_chunk,     \
                                 stream);
    F32OS_CASE(8, 64) F32OS_CASE(8, 128)
    F32OS_CASE(16, 64) F32OS_CASE(16, 128)
    F32OS_CASE(32, 64) F32OS_CASE(32, 128)
    F32OS_CASE(64, 64) F32OS_CASE(64, 128)
    F32OS_CASE(128, 64)
#undef F32OS_CASE
    return cudaErrorInvalidValue;
}

}  // namespace f32os
