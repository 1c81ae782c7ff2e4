// Dataflow-parameterised tiled matmul: C = A @ B, f32 accumulation and
// f32 output, A (M, K) and B (K, N) both f32 or both bf16, row-major,
// 128 x 128 x 128 tiles, ragged edges masked in the kernel.
//
// Replaces the TPU kernel src/repro/kernels/gemm_dataflow/kernel.py:
// matmul_dataflow (bodies _os_kernel and _revisit_kernel), and computes
// its oracle, src/repro/kernels/gemm_dataflow/ref.py: matmul_ref.  The
// dataflow is the paper's Table-6 reuse scheme; as in the Pallas
// kernel, it decides which operand stays resident on chip, not what is
// computed:
//
//   OUTPUT_STATIONARY (All Reuse)    one block per C tile (i, j); the
//       f32 psum stays in registers over the k sweep, C written once.
//   WEIGHT_STATIONARY (Filter Reuse) one block per column j of tiles;
//       for each kk, B(kk, j) stays resident in shared memory for the
//       whole i sweep; each C(i, j) is read, added to and written back
//       through device memory.
//   INPUT_STATIONARY  (Ifmap Reuse)  one block per row i; for each kk,
//       A(i, kk) stays resident over the j sweep; C revisited the same.
//   NO_REUSE                         k outermost: one launch per kk,
//       one block per C tile; both operands read again at every step,
//       and the psum goes through device memory at every kk.
//
// Parallelism runs only over an axis whose C tiles no two blocks share,
// so k is summed in ascending order with no atomics, and every tile
// product is formed from zero by the same code (tile_mma.cuh) and added
// with one rounded f32 addition: the four dataflows give the same bits.
//
// What bounds it on the H100: at the scout expert shape (M 8192, K 5120,
// N 8192, bf16) the tensor-core operations (2MNK / 989 TFLOP/s against
// 436 MB / 3.35 TB/s); for f32 operands the f32 FMA rate (67 TFLOP/s).
// What the design does about it: bf16 tiles go through mma.sync on the
// tensor cores with ldmatrix from bank-conflict-free padded shared
// memory; each staged 128 x 128 tile feeds 128 products per element.
// This first cut has no copy/compute overlap (no cp.async, TMA or
// wgmma), so it runs well below the tensor-core peak.  WS and IS give
// the card only N/128 or M/128 blocks (64 at the scout shape, on 132
// SMs) and round-trip every psum through device memory: they are the
// paper's reuse schemes, not a throughput design, and run slower.

#include "tile_mma.cuh"

namespace {

using tile::BK;
using tile::BM;
using tile::BN;
using tile::Mma;
using tile::PAIRS;
using tile::THREADS;

template <typename T>
__device__ __forceinline__ void smem_tiles(T*& sA, T*& sB) {
    extern __shared__ __align__(16) unsigned char smem[];
    sA = reinterpret_cast<T*>(smem);
    sB = sA + BM * Mma<T>::LDA;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gemm_output_stationary(const T* __restrict__ A, const T* __restrict__ B,
                       float* __restrict__ C, int M, int N, int K) {
    T *sA, *sB;
    smem_tiles(sA, sB);
    const int j = blockIdx.x, i = blockIdx.y;
    const int nk = (K + BK - 1) / BK;
    float acc[2 * PAIRS], part[2 * PAIRS];
#pragma unroll
    for (int e = 0; e < 2 * PAIRS; ++e) acc[e] = 0.f;
    for (int kk = 0; kk < nk; ++kk) {
        tile::stage(sA, sB, A, B, M, N, K, i, j, kk, true, true);
        __syncthreads();
        Mma<T>::product(sA, sB, part);
        __syncthreads();
        tile::accumulate(acc, part);
    }
    tile::write_tile<T>(C, M, N, i, j, acc, 0);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gemm_weight_stationary(const T* __restrict__ A, const T* __restrict__ B,
                       float* __restrict__ C, int M, int N, int K) {
    T *sA, *sB;
    smem_tiles(sA, sB);
    const int j = blockIdx.x;
    const int nk = (K + BK - 1) / BK, nm = (M + BM - 1) / BM;
    float part[2 * PAIRS];
    for (int kk = 0; kk < nk; ++kk) {
        tile::stage(sA, sB, A, B, M, N, K, 0, j, kk, false, true);
        for (int i = 0; i < nm; ++i) {
            tile::stage(sA, sB, A, B, M, N, K, i, j, kk, true, false);
            __syncthreads();
            Mma<T>::product(sA, sB, part);
            __syncthreads();
            tile::write_tile<T>(C, M, N, i, j, part, kk == 0 ? 1 : 2);
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gemm_input_stationary(const T* __restrict__ A, const T* __restrict__ B,
                      float* __restrict__ C, int M, int N, int K) {
    T *sA, *sB;
    smem_tiles(sA, sB);
    const int i = blockIdx.x;
    const int nk = (K + BK - 1) / BK, nn = (N + BN - 1) / BN;
    float part[2 * PAIRS];
    for (int kk = 0; kk < nk; ++kk) {
        tile::stage(sA, sB, A, B, M, N, K, i, 0, kk, true, false);
        for (int j = 0; j < nn; ++j) {
            tile::stage(sA, sB, A, B, M, N, K, i, j, kk, false, true);
            __syncthreads();
            Mma<T>::product(sA, sB, part);
            __syncthreads();
            tile::write_tile<T>(C, M, N, i, j, part, kk == 0 ? 1 : 2);
        }
    }
}

// one k step of NO_REUSE over every C tile
template <typename T>
__global__ void __launch_bounds__(THREADS)
gemm_no_reuse_step(const T* __restrict__ A, const T* __restrict__ B,
                   float* __restrict__ C, int M, int N, int K, int kk) {
    T *sA, *sB;
    smem_tiles(sA, sB);
    const int j = blockIdx.x, i = blockIdx.y;
    float part[2 * PAIRS];
    tile::stage(sA, sB, A, B, M, N, K, i, j, kk, true, true);
    __syncthreads();
    Mma<T>::product(sA, sB, part);
    tile::write_tile<T>(C, M, N, i, j, part, kk == 0 ? 1 : 2);
}

template <typename T>
int launch(const void* a, const void* b, void* c, int M, int N, int K,
           int dataflow, cudaStream_t stream) {
    const T* A = static_cast<const T*>(a);
    const T* B = static_cast<const T*>(b);
    float* C = static_cast<float*>(c);
    const int nm = (M + BM - 1) / BM, nn = (N + BN - 1) / BN;
    const int nk = (K + BK - 1) / BK;
    const size_t smem = Mma<T>::SMEM;
    cudaError_t err;
    switch (dataflow) {
    case 0:
        err = tile::allow_smem<T>((const void*)gemm_output_stationary<T>);
        if (err != cudaSuccess) return (int)err;
        gemm_output_stationary<T><<<dim3(nn, nm), THREADS, smem, stream>>>(
            A, B, C, M, N, K);
        break;
    case 1:
        err = tile::allow_smem<T>((const void*)gemm_weight_stationary<T>);
        if (err != cudaSuccess) return (int)err;
        gemm_weight_stationary<T><<<nn, THREADS, smem, stream>>>(
            A, B, C, M, N, K);
        break;
    case 2:
        err = tile::allow_smem<T>((const void*)gemm_input_stationary<T>);
        if (err != cudaSuccess) return (int)err;
        gemm_input_stationary<T><<<nm, THREADS, smem, stream>>>(
            A, B, C, M, N, K);
        break;
    case 3:
        err = tile::allow_smem<T>((const void*)gemm_no_reuse_step<T>);
        if (err != cudaSuccess) return (int)err;
        for (int kk = 0; kk < nk; ++kk) {
            gemm_no_reuse_step<T><<<dim3(nn, nm), THREADS, smem, stream>>>(
                A, B, C, M, N, K, kk);
            err = cudaGetLastError();
            if (err != cudaSuccess) return (int)err;
        }
        break;
    default:
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace

// dataflow: 0 output-, 1 weight-, 2 input-stationary, 3 no reuse.
// dtype: 0 float32, 1 bfloat16 (A and B alike; C is float32).
// Needs M, N >= 1 and K >= 1.  Returns the cudaError_t of the launch.
extern "C" int repro_gemm_dataflow(const void* a, const void* b, void* c,
                                   int M, int N, int K, int dataflow,
                                   int dtype, void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
    if (dtype == 0) return launch<float>(a, b, c, M, N, K, dataflow, s);
    if (dtype == 1)
        return launch<__nv_bfloat16>(a, b, c, M, N, K, dataflow, s);
    return (int)cudaErrorInvalidValue;
}
