// Tensor-core building blocks shared by the attention kernels
// (flash_attention.cu, its backward flash_attention_bwd.cu,
// paged_attention.cu): the XOR-swizzled layout of
// bf16 rows in shared memory, 16-byte cp.async into it, ldmatrix
// fragment loads, and the mma.sync m16n8k16 product (bf16 x bf16 ->
// f32).
//
// Layout: a tile of DH-wide bf16 rows, row r at byte r * DH * 2, its
// 16-byte chunk c stored at chunk position c ^ (r & 7).  Eight
// consecutive rows read at one chunk column hit eight different bank
// groups, so ldmatrix (eight rows of 16 bytes a matrix) is free of bank
// conflicts, plain or transposed.
//
// Fragments (PTX ISA, mma.m16n8k16 with .bf16): lane l of a warp holds
// rows l / 4 and l / 4 + 8 of the 16-row A tile and of the f32
// accumulator; accumulator values d[0..1] are row l / 4, d[2..3] row
// l / 4 + 8, columns 2 (l % 4) + {0, 1} of the n8 tile.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace attn {

// byte offset of 16-byte chunk c of row r in a tile of DH-wide rows
template <int DH>
__device__ __forceinline__ uint32_t swz(int r, int c) {
    return (uint32_t)(r * DH * 2 + ((c ^ (r & 7)) << 4));
}

// 16 bytes from global to shared memory, asynchronously; bytes = 0
// writes 16 zero bytes and reads nothing (src must still be a valid
// address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
}

// d += a b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), d 16 x 8 f32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace attn
