// The 128 x 128 x 128 tile shared by the dataflow GEMM
// (gemm_dataflow.cu, replacing src/repro/kernels/gemm_dataflow/
// kernel.py: matmul_dataflow) and the block-sparse GEMM
// (block_sparse.cu, replacing src/repro/kernels/block_sparse/kernel.py:
// matmul_block_sparse): the
// f32 tile product, and the epilogue (write_tile, accumulate) that
// both operand types share.  The bf16 tile product is the TMA + wgmma
// pipeline of wgmma_pipe.cuh.
//
// The bit contract, for both operand types: every 128-deep k tile is
// formed FROM ZERO in one fixed order, and the callers add it to their
// running f32 psum with one rounded addition (__fadd_rn, never
// contracted), wherever that psum lives: registers (output-stationary,
// block-sparse) or device memory (the revisit dataflows, write_tile
// modes 1 and 2).  Every caller performs the same sequence of f32
// operations on every output element, so the four dataflows, and the
// block-sparse kernel at density 1, give the same bits.
//
//   f32 operands (kept off the tensor cores by contract): f32 FMAs, no
//     TF32; a block of THREADS threads stages an A tile (BM x BK) and a
//     B tile (BK x BN) with load_tile(); thread (ty, tx) of a 16 x 16
//     grid owns rows ty + 16 r (r < 8) and column pairs 2 tx + 32 c
//     (c < 4), and runs one FMA chain per element over k = 0..127.
//     Mma<float> serves the f32 weight-stationary, input-stationary and
//     no-reuse dataflows and the block-sparse kernel; the f32
//     output-stationary product, which the serving path runs, is
//     gemm_f32.cuh, which performs the same chains and additions
//     (its result is held equal to NO_REUSE's).  Staging and FMAs do not
//     overlap here: at 1000 x 5120 x 1000 NO_REUSE takes 1.21 ms, the
//     old output-stationary kernel on this tile 0.95 ms, against a
//     0.153 ms FFMA bound (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W).
//
// A thread's 64 outputs are 32 pairs of horizontally adjacent
// elements; L::pair_coord(p) gives the tile coordinates of pair p in
// the layout L of the product that made them (Mma<float> here,
// pipe::Wgmma for bf16).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace tile {

constexpr int BM = 128, BN = 128, BK = 128;
constexpr int THREADS = 256;
constexpr int PAIRS = 32;            // output pairs per thread

template <typename T> struct Mma;

// Stage rows [r0, r0 + R) x cols [c0, c0 + C) of the row-major matrix
// g (rows x cols, leading dimension ld) into s (row stride LD), with
// zeros outside the matrix.  16-byte chunks where the source allows.
template <typename T, int R, int C, int LD>
__device__ __forceinline__ void load_tile(T* __restrict__ s,
                                          const T* __restrict__ g,
                                          int rows, int cols, int ld,
                                          int r0, int c0) {
    constexpr int VEC = 16 / sizeof(T);
    constexpr int CHUNKS = R * C / VEC;
    const bool vec_ok = (ld % VEC == 0) &&
                        ((reinterpret_cast<uintptr_t>(g) & 15) == 0);
    for (int idx = threadIdx.x; idx < CHUNKS; idx += THREADS) {
        const int r = idx / (C / VEC);
        const int c = (idx % (C / VEC)) * VEC;
        const int gr = r0 + r, gc = c0 + c;
        T* dst = s + r * LD + c;
        if (gr < rows && vec_ok && gc + VEC <= cols) {
            *reinterpret_cast<uint4*>(dst) =
                *reinterpret_cast<const uint4*>(g + (size_t)gr * ld + gc);
        } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
                dst[e] = (gr < rows && gc + e < cols)
                             ? g[(size_t)gr * ld + gc + e]
                             : T(0.f);
        }
    }
}

// ----------------------------------------------------------------- f32
template <> struct Mma<float> {
    using T = float;
    // A rows padded by 4 floats: 16-byte aligned, and the two rows a
    // warp reads at once sit 4 banks apart
    static constexpr int LDA = BK + 4, LDB = BN;
    static constexpr size_t SMEM = sizeof(T) * (size_t)(BM * LDA + BK * LDB);

    __device__ static __forceinline__ void pair_coord(int p, int& r, int& c) {
        const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
        r = ty + 16 * (p >> 2);
        c = 2 * tx + 32 * (p & 3);
    }

    __device__ static __forceinline__ void product(const T* __restrict__ sA,
                                                   const T* __restrict__ sB,
                                                   float (&part)[2 * PAIRS]) {
        const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
        for (int e = 0; e < 2 * PAIRS; ++e) part[e] = 0.f;
#pragma unroll 2
        for (int k0 = 0; k0 < BK; k0 += 4) {
            float4 a[8];
#pragma unroll
            for (int r = 0; r < 8; ++r)
                a[r] = *reinterpret_cast<const float4*>(
                    sA + (ty + 16 * r) * LDA + k0);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                float2 b[4];
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    b[c] = *reinterpret_cast<const float2*>(
                        sB + (k0 + kk) * LDB + 2 * tx + 32 * c);
#pragma unroll
                for (int r = 0; r < 8; ++r) {
                    const float av = kk == 0 ? a[r].x : kk == 1 ? a[r].y
                                   : kk == 2 ? a[r].z : a[r].w;
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        float* d = part + (r * 4 + c) * 2;
                        d[0] = fmaf(av, b[c].x, d[0]);
                        d[1] = fmaf(av, b[c].y, d[1]);
                    }
                }
            }
        }
    }
};

template <typename T>
__device__ __forceinline__ void stage(T* sA, T* sB, const T* A, const T* B,
                                      int M, int N, int K, int i, int j,
                                      int kk, bool load_a, bool load_b) {
    if (load_a)
        load_tile<T, BM, BK, Mma<T>::LDA>(sA, A, M, K, K, i * BM, kk * BK);
    if (load_b)
        load_tile<T, BK, BN, Mma<T>::LDB>(sB, B, K, N, N, kk * BK, j * BN);
}

// Write a thread's 32 pairs of tile (i, j) of C (M x N, f32), laid out
// as L's product leaves them.
// mode 0: C = v.  mode 1: C = 0 + v (first k step of a revisit
// dataflow).  mode 2: C = C + v (later k steps).  Every read of C is
// issued before the first write, so the 32 reads are in flight
// together rather than one round trip per pair.
template <typename L>
__device__ __forceinline__ void write_tile(float* __restrict__ C, int M,
                                           int N, int i, int j,
                                           const float (&v)[2 * PAIRS],
                                           int mode) {
    const bool pair_ok = (N % 2 == 0) &&
                         ((reinterpret_cast<uintptr_t>(C) & 7) == 0);
    float old[2 * PAIRS];
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
        int r, c;
        L::pair_coord(p, r, c);
        r += i * BM;
        c += j * BN;
        old[2 * p] = old[2 * p + 1] = 0.f;
        if (mode != 2 || r >= M) continue;
        const float* src = C + (size_t)r * N + c;
        if (pair_ok && c + 1 < N) {
            const float2 o = *reinterpret_cast<const float2*>(src);
            old[2 * p] = o.x;
            old[2 * p + 1] = o.y;
        } else {
            if (c < N) old[2 * p] = src[0];
            if (c + 1 < N) old[2 * p + 1] = src[1];
        }
    }
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
        int r, c;
        L::pair_coord(p, r, c);
        r += i * BM;
        c += j * BN;
        if (r >= M) continue;
        float* dst = C + (size_t)r * N + c;
        float v0 = v[2 * p], v1 = v[2 * p + 1];
        if (mode != 0) {
            v0 = __fadd_rn(old[2 * p], v0);
            v1 = __fadd_rn(old[2 * p + 1], v1);
        }
        if (pair_ok && c + 1 < N) {
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
            if (c < N) dst[0] = v0;
            if (c + 1 < N) dst[1] = v1;
        }
    }
}

__device__ __forceinline__ void accumulate(float (&acc)[2 * PAIRS],
                                           const float (&part)[2 * PAIRS]) {
#pragma unroll
    for (int e = 0; e < 2 * PAIRS; ++e) acc[e] = __fadd_rn(acc[e], part[e]);
}

template <typename T>
inline cudaError_t allow_smem(const void* kernel) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)Mma<T>::SMEM);
}

}  // namespace tile
