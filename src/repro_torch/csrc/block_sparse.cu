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
// Each output tile (i, j) is owned by one block (bf16: persistent
// blocks, one per SM, each walking tiles gridDim.x apart), which walks
// column j's live k tiles in ascending k and keeps the f32 psum in
// registers; a column with no live tile is written as exactly 0.0.
// Dead tiles cost no B bytes and no operations.
//
// What bounds it on the H100: at the scout expert shape and the paper's
// Table-3 keep rates (0.27-0.38) the tensor-core operations of the live
// tiles.  What the design does about it: bf16 operands take the
// output-stationary main loop of wgmma_pipe.cuh (TMA producer warp
// reading live_k, 3-stage ring, two wgmma consumer warpgroups),
// so operations and B bytes scale with the live tiles alone and copies
// overlap the products; f32 operands keep tile_mma.cuh's FMA product.
// The tile product and its one rounded addition are the dataflow
// GEMM's, so at density 1 this kernel gives the bits of its output-
// stationary dataflow.  Blocks are not balanced: columns with more
// live tiles take longer.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W, L2 flushed
// before each call), scout bf16: keep 0.36 3.45 ms before this
// pipeline (mma.sync, no overlap), 1.12 ms with it; keep 0.27 / 0.35 /
// 0.38 0.83 / 0.85 / 0.85 ms, against 0.81-0.85 ms for dense cuBLAS on
// the masked B.

#include "wgmma_pipe.cuh"

namespace {

using tile::BK;
using tile::BM;
using tile::BN;
using tile::PAIRS;
using tile::THREADS;
using F = tile::Mma<float>;

__global__ void __launch_bounds__(THREADS)
block_sparse_f32(const float* __restrict__ A, const float* __restrict__ B,
                 const int* __restrict__ col_start,
                 const int* __restrict__ live_k, float* __restrict__ C,
                 int M, int N, int K) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* sA = reinterpret_cast<float*>(smem);
    float* sB = sA + BM * F::LDA;
    const int j = blockIdx.x, i = blockIdx.y;
    const int s0 = col_start[j], s1 = col_start[j + 1];
    float acc[2 * PAIRS], part[2 * PAIRS];
#pragma unroll
    for (int e = 0; e < 2 * PAIRS; ++e) acc[e] = 0.f;
    for (int s = s0; s < s1; ++s) {
        const int kk = live_k[s];
        tile::stage(sA, sB, A, B, M, N, K, i, j, kk, true, true);
        __syncthreads();
        F::product(sA, sB, part);
        __syncthreads();
        tile::accumulate(acc, part);
    }
    tile::write_tile<F>(C, M, N, i, j, acc, 0);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (A and B alike; C is float32).
// producer (bf16 only): 0 TMA, 1 cp.async; TMA is refused unless both
// operands have 16-byte aligned bases and row strides.
// col_start: (ceil(N/128) + 1,) int32; live_k: (col_start[-1],) int32.
// Needs M, N >= 1.  Returns the cudaError_t of the launch.
extern "C" int repro_block_sparse(const void* a, const void* b,
                                  const void* col_start, const void* live_k,
                                  void* c, int M, int N, int K, int dtype,
                                  int producer, void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    auto cs = static_cast<const int*>(col_start);
    auto lk = static_cast<const int*>(live_k);
    if (M < 1 || N < 1 || K < 0) return (int)cudaErrorInvalidValue;
    const int nm = (M + BM - 1) / BM, nn = (N + BN - 1) / BN;
    if (dtype == 0) {
        cudaError_t err =
            tile::allow_smem<float>((const void*)block_sparse_f32);
        if (err != cudaSuccess) return (int)err;
        block_sparse_f32<<<dim3(nn, nm), THREADS, F::SMEM, s>>>(
            static_cast<const float*>(a), static_cast<const float*>(b), cs,
            lk, static_cast<float*>(c), M, N, K);
        return (int)cudaGetLastError();
    }
    if (dtype != 1 || (producer != 0 && producer != 1))
        return (int)cudaErrorInvalidValue;
    pipe::Args args{static_cast<const pipe::bf16*>(a),
                    static_cast<const pipe::bf16*>(b),
                    static_cast<float*>(c), M, N, K, cs, lk, 0,
                    producer == 0};
    CUtensorMap ma, mb;
    cudaError_t err = pipe::maps_for(args, &ma, &mb);
    if (err != cudaSuccess) return (int)err;
    return (int)pipe::launch<pipe::BS>(args, ma, mb, nm * nn, s);
}
