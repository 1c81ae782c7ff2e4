// Block-sparse matmul: C = A @ (B under a (K/128, N/128) tile mask),
// f32 accumulation and f32 output, A (M, K) and B (K, N) both f32 or
// both bf16, row-major, ragged edges masked in the kernel.
//
// Replaces the TPU kernel src/repro/kernels/block_sparse/kernel.py:
// matmul_block_sparse (body _kernel), and computes what
// src/repro/kernels/block_sparse/ops.py: matmul returns (columns with
// no live tile are 0), i.e. ref.py: matmul_block_sparse_ref.  It is the
// paper's Sparse PC Inc (Fig 19) at tile granularity: the host compiles
// the mask into a jump table (ops.compile_mask), and the kernel walks
// only the live tiles.
//
// Layout of the jump table on the card: live_k (n_live,) holds the k
// tile of every live tile, column by column, ascending k within a
// column (compile_mask's order); col_start (N/128 + 1,) holds where
// column j's run starts, so column j's live k tiles are
// live_k[col_start[j] .. col_start[j + 1]).  Each block reads its own
// offsets, the GPU's counterpart of the Pallas kernel's scalar
// prefetch.  A fully pruned mask has n_live = 0 here: compile_mask's
// one-step sentinel is never computed into C.
//
// One block per output tile (i, j) walks column j's live k tiles in
// ascending k and keeps the f32 psum in registers; a column with no
// live tile is written as exactly 0.0.  Dead tiles cost no B bytes and
// no operations.  The tile product is tile_mma.cuh's, added with one
// rounded f32 addition as in gemm_dataflow.cu, so at density 1 this
// kernel gives the bits of the output-stationary dataflow.
//
// What bounds it on the H100: at the scout expert shape and the paper's
// Table-3 keep rates (0.27-0.38) the tensor-core operations of the live
// tiles.  What the design does about it: operations and B bytes scale
// with the live tiles alone; A tiles of a row are re-read from L2 by the
// blocks of that row.  No copy/compute overlap yet (as gemm_dataflow).

#include "tile_mma.cuh"

namespace {

using tile::BK;
using tile::BM;
using tile::BN;
using tile::Mma;
using tile::PAIRS;
using tile::THREADS;

template <typename T>
__global__ void __launch_bounds__(THREADS)
block_sparse_kernel(const T* __restrict__ A, const T* __restrict__ B,
                    const int* __restrict__ col_start,
                    const int* __restrict__ live_k, float* __restrict__ C,
                    int M, int N, int K) {
    extern __shared__ __align__(16) unsigned char smem[];
    T* sA = reinterpret_cast<T*>(smem);
    T* sB = sA + BM * Mma<T>::LDA;
    const int j = blockIdx.x, i = blockIdx.y;
    const int s0 = col_start[j], s1 = col_start[j + 1];
    float acc[2 * PAIRS], part[2 * PAIRS];
#pragma unroll
    for (int e = 0; e < 2 * PAIRS; ++e) acc[e] = 0.f;
    for (int s = s0; s < s1; ++s) {
        const int kk = live_k[s];
        tile::stage(sA, sB, A, B, M, N, K, i, j, kk, true, true);
        __syncthreads();
        Mma<T>::product(sA, sB, part);
        __syncthreads();
        tile::accumulate(acc, part);
    }
    tile::write_tile<T>(C, M, N, i, j, acc, 0);
}

template <typename T>
int launch(const void* a, const void* b, const int* col_start,
           const int* live_k, void* c, int M, int N, int K,
           cudaStream_t stream) {
    cudaError_t err =
        tile::allow_smem<T>((const void*)block_sparse_kernel<T>);
    if (err != cudaSuccess) return (int)err;
    const int nm = (M + BM - 1) / BM, nn = (N + BN - 1) / BN;
    block_sparse_kernel<T><<<dim3(nn, nm), THREADS, Mma<T>::SMEM, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), col_start,
        live_k, static_cast<float*>(c), M, N, K);
    return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (A and B alike; C is float32).
// col_start: (ceil(N/128) + 1,) int32; live_k: (col_start[-1],) int32.
// Needs M, N >= 1.  Returns the cudaError_t of the launch.
extern "C" int repro_block_sparse(const void* a, const void* b,
                                  const void* col_start, const void* live_k,
                                  void* c, int M, int N, int K, int dtype,
                                  void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    auto cs = static_cast<const int*>(col_start);
    auto lk = static_cast<const int*>(live_k);
    if (M < 1 || N < 1 || K < 0) return (int)cudaErrorInvalidValue;
    if (dtype == 0) return launch<float>(a, b, cs, lk, c, M, N, K, s);
    if (dtype == 1)
        return launch<__nv_bfloat16>(a, b, cs, lk, c, M, N, K, s);
    return (int)cudaErrorInvalidValue;
}
