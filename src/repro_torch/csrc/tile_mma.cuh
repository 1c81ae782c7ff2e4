// One 128 x 128 x 128 tile product, shared by the dataflow GEMM
// (gemm_dataflow.cu) and the block-sparse GEMM (block_sparse.cu).
//
// A block of THREADS threads stages an A tile (BM x BK) and a B tile
// (BK x BN) in shared memory with load_tile(), then product() forms
// part = A_tile @ B_tile in f32 registers FROM ZERO, walking k in one
// fixed order.  The callers add part to their running f32 psum with
// one rounded addition (__fadd_rn, never contracted), wherever that
// psum lives: registers (output-stationary, block-sparse) or device
// memory (the revisit dataflows).  Every caller therefore performs the
// same sequence of f32 operations on every output element, so the
// four dataflows, and the block-sparse kernel at density 1, give the
// same bits.
//
//   bf16 operands: tensor-core mma.sync m16n8k16 (bf16 x bf16 -> f32),
//     fragments read with ldmatrix; 8 warps as 4 (rows) x 2 (cols),
//     each warp a 32 x 64 sub-tile, eight k16 steps in ascending k.
//   f32 operands: f32 FMAs (no TF32); thread (ty, tx) of a 16 x 16
//     grid owns rows ty + 16 r (r < 8) and column pairs 2 tx + 32 c
//     (c < 4), and runs one FMA chain per element over k = 0..127.
//
// A thread's 64 outputs are 32 pairs of horizontally adjacent
// elements; pair_coord(p) gives the tile coordinates of pair p.

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

// ---------------------------------------------------------------- bf16
template <> struct Mma<__nv_bfloat16> {
    using T = __nv_bfloat16;
    // rows padded by 8 elements (16 bytes): the 8 row addresses of an
    // ldmatrix land on distinct banks
    static constexpr int LDA = BK + 8, LDB = BN + 8;
    static constexpr size_t SMEM = sizeof(T) * (size_t)(BM * LDA + BK * LDB);

    __device__ static __forceinline__ void pair_coord(int p, int& r, int& c) {
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
        const int mt = p >> 4, nt = (p >> 1) & 7, h = p & 1;
        r = (warp >> 1) * 32 + mt * 16 + (lane >> 2) + 8 * h;
        c = (warp & 1) * 64 + nt * 8 + 2 * (lane & 3);
    }

    __device__ static __forceinline__ void product(const T* __restrict__ sA,
                                                   const T* __restrict__ sB,
                                                   float (&part)[2 * PAIRS]) {
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
        const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
#pragma unroll
        for (int e = 0; e < 2 * PAIRS; ++e) part[e] = 0.f;
#pragma unroll
        for (int k0 = 0; k0 < BK; k0 += 16) {
            uint32_t a[2][4], b[8][2];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
                const T* p = sA + (wm + mt * 16 + (lane & 15)) * LDA + k0 +
                             (lane >> 4) * 8;
                const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
                asm volatile(
                    "ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                    "{%0, %1, %2, %3}, [%4];\n"
                    : "=r"(a[mt][0]), "=r"(a[mt][1]), "=r"(a[mt][2]),
                      "=r"(a[mt][3])
                    : "r"(addr));
            }
#pragma unroll
            for (int np = 0; np < 4; ++np) {
                const T* p = sB + (k0 + (lane & 15)) * LDB + wn + np * 16 +
                             (lane >> 4) * 8;
                const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
                asm volatile(
                    "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                    "{%0, %1, %2, %3}, [%4];\n"
                    : "=r"(b[2 * np][0]), "=r"(b[2 * np][1]),
                      "=r"(b[2 * np + 1][0]), "=r"(b[2 * np + 1][1])
                    : "r"(addr));
            }
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int nt = 0; nt < 8; ++nt) {
                    float* d = part + (mt * 8 + nt) * 4;
                    asm volatile(
                        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                        "{%0, %1, %2, %3};\n"
                        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                        : "r"(a[mt][0]), "r"(a[mt][1]), "r"(a[mt][2]),
                          "r"(a[mt][3]), "r"(b[nt][0]), "r"(b[nt][1]));
                }
        }
    }
};

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

// Write a thread's 32 pairs of tile (i, j) of C (M x N, f32).
// mode 0: C = v.  mode 1: C = 0 + v (first k step of a revisit
// dataflow).  mode 2: C = C + v (later k steps).
template <typename T>
__device__ __forceinline__ void write_tile(float* __restrict__ C, int M,
                                           int N, int i, int j,
                                           const float (&v)[2 * PAIRS],
                                           int mode) {
    const bool pair_ok = (N % 2 == 0) &&
                         ((reinterpret_cast<uintptr_t>(C) & 7) == 0);
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
        int r, c;
        Mma<T>::pair_coord(p, r, c);
        r += i * BM;
        c += j * BN;
        if (r >= M) continue;
        float* dst = C + (size_t)r * N + c;
        const float v0 = v[2 * p], v1 = v[2 * p + 1];
        if (pair_ok && c + 1 < N) {
            float2 o = make_float2(v0, v1);
            if (mode != 0) {
                float2 old = mode == 2 ? *reinterpret_cast<float2*>(dst)
                                       : make_float2(0.f, 0.f);
                o.x = __fadd_rn(old.x, v0);
                o.y = __fadd_rn(old.y, v1);
            }
            *reinterpret_cast<float2*>(dst) = o;
        } else {
            if (c < N)
                dst[0] = mode == 0 ? v0
                                   : __fadd_rn(mode == 2 ? dst[0] : 0.f, v0);
            if (c + 1 < N)
                dst[1] = mode == 0 ? v1
                                   : __fadd_rn(mode == 2 ? dst[1] : 0.f, v1);
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
