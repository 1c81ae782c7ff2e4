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
//   OUTPUT_STATIONARY (All Reuse)    each C tile (i, j) is owned by one
//       block (bf16: persistent blocks, one per SM, each walking tiles
//       gridDim.x apart); the f32 psum stays in registers over the k
//       sweep, C written once.  f32 operands: gemm_f32.cuh, whose tile
//       follows the shape and which may split the k sweep over blocks
//       (each k tile's product through an f32 workspace, added in
//       ascending k by a second launch: the same additions).
//   WEIGHT_STATIONARY (Filter Reuse) one block per column j of tiles;
//       for each kk, B(kk, j) stays resident in shared memory for the
//       whole i sweep; each C(i, j) is read, added to and written back
//       through device memory.
//   INPUT_STATIONARY  (Ifmap Reuse)  one block per row i; for each kk,
//       A(i, kk) stays resident over the j sweep; C revisited the same.
//   NO_REUSE                         k outermost: one launch per kk
//       over every C tile (bf16: persistent blocks as OS); both
//       operands read again at every step, and the psum goes through
//       device memory at every kk.
//
// Parallelism runs only over an axis whose C tiles no two blocks share,
// so k is summed in ascending order with no atomics, and every tile
// product is formed from zero by the same code and added with one
// rounded f32 addition (the contract of tile_mma.cuh): the four
// dataflows give the same bits.
//
// What bounds it on the H100: at the scout expert shape (M 8192, K 5120,
// N 8192, bf16) the tensor-core operations (2MNK / 989 TFLOP/s = 0.695
// ms against 436 MB / 3.35 TB/s); for WS, IS and NR also the f32 psum
// round trips through device memory (C is 268 MB, read and written at
// each of the 40 k steps); for f32 operands the f32 FMA rate.
// What the design does about it: bf16 operands go through
// wgmma_pipe.cuh, a warp-specialised pipeline (one TMA producer warp,
// two wgmma consumer warpgroups, a 3-stage ring of 128 x 128 tiles in
// 192 KB of shared memory) in which copies overlap the tensor-core
// products; the tiles in flight at once lie in groups of 16 rows of
// tiles, so they share operand tiles in L2.  Operands
// whose base or row stride is not 16-byte aligned are fetched by a
// cp.async producer into the same swizzled layout.  f32 operands stay
// off the tensor cores by contract (f32 FMAs, no TF32): OS runs
// gemm_f32.cuh (a cp.async ring of 32-deep sub-tiles under the FMAs, a
// tile of 8-128 rows and 64 or 128 columns chosen from the shape, k
// split over whole k tiles when the output tiles leave SMs idle); WS,
// IS and NR keep tile_mma.cuh's FMA tile product, staged through
// registers, and are the yardstick the OS bits are held to.
// WS and IS give the card only N/128 or M/128 blocks (64 at the scout
// shape, on 132 SMs): they are the paper's reuse schemes, not a
// throughput design.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W, L2 flushed
// before each call), scout bf16: before this pipeline (ldmatrix +
// mma.sync, no overlap) OS 10.77, NR 14.89, WS 44.85, IS 44.86 ms; with
// it OS 1.36-1.41 (torch.matmul 0.88), NR 9.53, WS 10.68, IS 10.48 ms.
// f32, 1000 x 5120 x 1000: OS 0.37-0.43 ms on gemm_f32.cuh (0.95 on
// the FMA tile; torch.matmul 0.25), NR 1.21-1.26, WS 7.0-7.1, IS
// 7.1-7.2 ms.
// OS now moves its 10.7 GB of operand tiles from L2 at about 7.7 TB/s
// with one 128 x 128 tile per SM; WS and IS serialise each step's psum
// round trip through C with the next product on 64 SMs.  Ragged bf16
// (cp.async producer): OS 0.79, NR 1.27, WS 5.09, IS 4.56 ms.

#include "gemm_f32.cuh"
#include "wgmma_pipe.cuh"

namespace {

// the f32 output-stationary kernel's plan (ops.plan_f32)
struct F32Plan {
    int bm, bn, tiles_per_chunk;
    float* ws;
};

using tile::BK;
using tile::BM;
using tile::BN;
using tile::Mma;
using tile::PAIRS;
using tile::THREADS;

// ------------------------------------------------------------ f32
__device__ __forceinline__ void smem_tiles(float*& sA, float*& sB) {
    extern __shared__ __align__(16) unsigned char smem[];
    sA = reinterpret_cast<float*>(smem);
    sB = sA + BM * Mma<float>::LDA;
}

using F = Mma<float>;

__global__ void __launch_bounds__(THREADS)
gemm_weight_stationary(const float* __restrict__ A, const float* __restrict__ B,
                       float* __restrict__ C, int M, int N, int K) {
    float *sA, *sB;
    smem_tiles(sA, sB);
    const int j = blockIdx.x;
    const int nk = (K + BK - 1) / BK, nm = (M + BM - 1) / BM;
    float part[2 * PAIRS];
    for (int kk = 0; kk < nk; ++kk) {
        tile::stage(sA, sB, A, B, M, N, K, 0, j, kk, false, true);
        for (int i = 0; i < nm; ++i) {
            tile::stage(sA, sB, A, B, M, N, K, i, j, kk, true, false);
            __syncthreads();
            F::product(sA, sB, part);
            __syncthreads();
            tile::write_tile<F>(C, M, N, i, j, part, kk == 0 ? 1 : 2);
        }
    }
}

__global__ void __launch_bounds__(THREADS)
gemm_input_stationary(const float* __restrict__ A, const float* __restrict__ B,
                      float* __restrict__ C, int M, int N, int K) {
    float *sA, *sB;
    smem_tiles(sA, sB);
    const int i = blockIdx.x;
    const int nk = (K + BK - 1) / BK, nn = (N + BN - 1) / BN;
    float part[2 * PAIRS];
    for (int kk = 0; kk < nk; ++kk) {
        tile::stage(sA, sB, A, B, M, N, K, i, 0, kk, true, false);
        for (int j = 0; j < nn; ++j) {
            tile::stage(sA, sB, A, B, M, N, K, i, j, kk, false, true);
            __syncthreads();
            F::product(sA, sB, part);
            __syncthreads();
            tile::write_tile<F>(C, M, N, i, j, part, kk == 0 ? 1 : 2);
        }
    }
}

// one k step of NO_REUSE over every C tile
__global__ void __launch_bounds__(THREADS)
gemm_no_reuse_step(const float* __restrict__ A, const float* __restrict__ B,
                   float* __restrict__ C, int M, int N, int K, int kk) {
    float *sA, *sB;
    smem_tiles(sA, sB);
    const int j = blockIdx.x, i = blockIdx.y;
    float part[2 * PAIRS];
    tile::stage(sA, sB, A, B, M, N, K, i, j, kk, true, true);
    __syncthreads();
    F::product(sA, sB, part);
    tile::write_tile<F>(C, M, N, i, j, part, kk == 0 ? 1 : 2);
}

int launch_f32(const float* A, const float* B, float* C, int M, int N, int K,
               int dataflow, const F32Plan& plan, cudaStream_t stream) {
    const int nm = (M + BM - 1) / BM, nn = (N + BN - 1) / BN;
    const int nk = (K + BK - 1) / BK;
    const size_t smem = F::SMEM;
    cudaError_t err;
    switch (dataflow) {
    case 0:
        return (int)f32os::launch(A, B, C, plan.ws, M, N, K, plan.bm,
                                  plan.bn, plan.tiles_per_chunk, stream);
    case 1:
        err = tile::allow_smem<float>((const void*)gemm_weight_stationary);
        if (err != cudaSuccess) return (int)err;
        gemm_weight_stationary<<<nn, THREADS, smem, stream>>>(A, B, C, M, N,
                                                              K);
        break;
    case 2:
        err = tile::allow_smem<float>((const void*)gemm_input_stationary);
        if (err != cudaSuccess) return (int)err;
        gemm_input_stationary<<<nm, THREADS, smem, stream>>>(A, B, C, M, N,
                                                             K);
        break;
    case 3:
        err = tile::allow_smem<float>((const void*)gemm_no_reuse_step);
        if (err != cudaSuccess) return (int)err;
        for (int kk = 0; kk < nk; ++kk) {
            gemm_no_reuse_step<<<dim3(nn, nm), THREADS, smem, stream>>>(
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

// ----------------------------------------------------------- bf16
int launch_bf16(const void* a, const void* b, void* c, int M, int N, int K,
                int dataflow, int use_tma, cudaStream_t stream) {
    pipe::Args args{static_cast<const pipe::bf16*>(a),
                    static_cast<const pipe::bf16*>(b),
                    static_cast<float*>(c), M, N, K, nullptr, nullptr, 0,
                    use_tma};
    CUtensorMap ma, mb;
    cudaError_t err = pipe::maps_for(args, &ma, &mb);
    if (err != cudaSuccess) return (int)err;
    const int nm = (M + BM - 1) / BM, nn = (N + BN - 1) / BN;
    const int nk = (K + BK - 1) / BK;
    switch (dataflow) {
    case 0:
        return (int)pipe::launch<pipe::OS>(args, ma, mb, nm * nn, stream);
    case 1:
        return (int)pipe::launch<pipe::WS>(args, ma, mb, nn, stream);
    case 2:
        return (int)pipe::launch<pipe::IS>(args, ma, mb, nm, stream);
    case 3:
        for (int kk = 0; kk < nk; ++kk) {
            args.kk = kk;
            err = pipe::launch<pipe::NR>(args, ma, mb, nm * nn, stream);
            if (err != cudaSuccess) return (int)err;
        }
        return 0;
    default:
        return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// dataflow: 0 output-, 1 weight-, 2 input-stationary, 3 no reuse.
// dtype: 0 float32, 1 bfloat16 (A and B alike; C is float32).
// producer (bf16 only): 0 TMA, 1 cp.async; TMA is refused unless both
// operands have 16-byte aligned bases and row strides.
// bm, bn, tiles_per_chunk, ws (f32 output-stationary only): the plan of
// ops.plan_f32 and, when it splits k, an f32 workspace of
// ceil(K / 128) x M x N floats.
// Needs M, N >= 1 and K >= 1.  Returns the cudaError_t of the launch.
extern "C" int repro_gemm_dataflow(const void* a, const void* b, void* c,
                                   int M, int N, int K, int dataflow,
                                   int dtype, int producer, int bm, int bn,
                                   int tiles_per_chunk, void* ws,
                                   void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        return launch_f32(static_cast<const float*>(a),
                          static_cast<const float*>(b),
                          static_cast<float*>(c), M, N, K, dataflow,
                          F32Plan{bm, bn, tiles_per_chunk,
                                  static_cast<float*>(ws)},
                          s);
    if (dtype == 1 && (producer == 0 || producer == 1))
        return launch_bf16(a, b, c, M, N, K, dataflow, producer == 0, s);
    return (int)cudaErrorInvalidValue;
}
