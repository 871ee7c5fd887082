// Device helpers shared by the port's flash-attention kernels (sm_90a):
// tile geometry, cp.async staging, ldmatrix fragment loads and the bf16
// mma.sync m16n8k16 product.
//
// Every kernel keeps its tiles in shared memory as row-major [rows][D]
// with rows padded to kStride elements (272 bytes), so the eight rows an
// ldmatrix reads fall in distinct banks.  Fragment layouts are those of
// mma.sync.m16n8k16 (lane = 4 * g + t):
//   A (16x16, row-major): a[0] = A[g][2t..], a[1] = A[g+8][2t..],
//                         a[2] = A[g][2t+8..], a[3] = A[g+8][2t+8..]
//   B (16x8, col-major):  b[0] = B[2t..][g], b[1] = B[2t+8..][g]
//   C (16x8):             c[0..1] = C[g][2t..], c[2..3] = C[g+8][2t..]

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nos_flash {

constexpr int kHeadDim = 128;
constexpr int kTileRows = 64;            // rows of a q, k or v tile
constexpr int kStride = kHeadDim + 8;    // padded shared row, in elements
constexpr int kTileElems = kTileRows * kStride;
constexpr int kChunks = kHeadDim / 8;    // 16-byte chunks per row
constexpr int kWarps = 4;                // 16 tile rows per warp
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a . b for one 16x8x16 tile (a row-major 16x16, b col-major 16x8).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand of k-step kk re-packed (rounded to bf16) from a 16-row
// C accumulator c[n-tile][4]: columns 16kk..16kk+15 are n-tiles 2kk, 2kk+1.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c)[8][4],
                                       int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Stage rows [row0, row0 + 64) of one (batch, head) slice into shared
// memory; rows at or past `nrows` are zero-filled.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int64_t row_stride, int row0,
                                          int nrows) {
#pragma unroll
  for (int i = threadIdx.x; i < kTileRows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool valid = row0 + r < nrows;
    const __nv_bfloat16* p = valid ? src + (row0 + r) * row_stride + c : src;
    cp_async16(smem_addr(dst + r * kStride + c), p, valid);
  }
}

// Store rows [0, 64) of a staged shared tile to rows [row0, row0 + 64) of
// one (batch, head) slice with 16-byte writes; rows at or past `nrows`
// are not stored.
__device__ __forceinline__ void store_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           int64_t row_stride, int row0,
                                           int nrows) {
#pragma unroll
  for (int i = threadIdx.x; i < kTileRows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    if (row0 + r < nrows)
      *reinterpret_cast<uint4*>(dst + (row0 + r) * row_stride + c) =
          *reinterpret_cast<const uint4*>(src + r * kStride + c);
  }
}

// Write a warp's 16 x 128 fp32 accumulator, times `mul` and rounded to
// bf16, into rows [row, row + 16) of a shared tile.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* tile, int row,
                                           const float (&acc)[16][4],
                                           float mul, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int d = 0; d < kHeadDim / 8; ++d) {
    const int c = d * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(tile + (row + g) * kStride + c) =
        pack_bf16(acc[d][0] * mul, acc[d][1] * mul);
    *reinterpret_cast<uint32_t*>(tile + (row + g + 8) * kStride + c) =
        pack_bf16(acc[d][2] * mul, acc[d][3] * mul);
  }
}

// Fragment loads from a row-major shared tile whose rows are `stride`
// elements apart.
//
// A (16x16) with tile rows = M and tile columns = K.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int stride,
                                       int m0, int k0, int lane) {
  const int r = m0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = k0 + (lane >> 4) * 8;
  ldmatrix_x4(a, smem_addr(tile + r * stride + c));
}

// A (16x16) from the transpose of the tile: tile rows = K, columns = M.
__device__ __forceinline__ void frag_a_trans(uint32_t (&a)[4],
                                             const __nv_bfloat16* tile,
                                             int stride, int m0, int k0,
                                             int lane) {
  const int r = k0 + (lane & 7) + (lane >> 4) * 8;
  const int c = m0 + ((lane >> 3) & 1) * 8;
  ldmatrix_x4_trans(a, smem_addr(tile + r * stride + c));
}

// B for two 8-wide n-tiles and one 16-deep k-step (b[0..1] for columns
// n0..n0+7, b[2..3] for n0+8..n0+15), with tile rows = N and columns = K
// (B is the tile transposed: the K of Q.K^T).
__device__ __forceinline__ void frag_b(uint32_t (&b)[4],
                                       const __nv_bfloat16* tile, int stride,
                                       int n0, int k0, int lane) {
  const int r = n0 + (lane & 7) + (lane >> 4) * 8;
  const int c = k0 + ((lane >> 3) & 1) * 8;
  ldmatrix_x4(b, smem_addr(tile + r * stride + c));
}

// The same with tile rows = K and columns = N (B is the tile: the V of P.V).
__device__ __forceinline__ void frag_b_trans(uint32_t (&b)[4],
                                             const __nv_bfloat16* tile,
                                             int stride, int k0, int n0,
                                             int lane) {
  const int r = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = n0 + (lane >> 4) * 8;
  ldmatrix_x4_trans(b, smem_addr(tile + r * stride + c));
}

}  // namespace nos_flash
