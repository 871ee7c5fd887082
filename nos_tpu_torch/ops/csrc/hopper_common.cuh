// Hopper machinery shared by the redesigned flash kernels (K1 in
// flash_fwd.cu, K2 in flash_bwd.cu), sm_90a only: TMA tensor maps and
// loads/stores, mbarriers, wgmma descriptors and products, register
// rebalancing and named barriers.  Each piece follows the section of
// cuda_guide.md named beside it.
//
// Tiles in shared memory.  A [rows x 128] bf16 tile (one head's rows) is
// two "column halves" of [rows x 64], each rows x 128 bytes, half 1 right
// after half 0.  TMA writes each half with CU_TENSOR_MAP_SWIZZLE_128B: the
// 16-byte chunk c of row r lands at chunk c ^ (r % 8), so every half must
// start on a 1024-byte boundary (swizzled_offset() computes the same
// place for a thread's own stores).  wgmma reads the halves through
// 128B-swizzled descriptors (smem_desc):
//   K-major operand (the reduction dim D contiguous: Q and K in Q.K^T):
//     k-step kk of 16 columns starts at half (kk / 4) + (kk % 4) * 32
//     bytes; SBO = 1024 (8 rows), LBO unused.
//   MN-major operand (the output dim contiguous: V in P.V, dO and Q in
//     dV/dK, K and dS^T in dQ): k-step kk of 16 rows starts at
//     kk * 16 * 128 bytes; SBO = 1024 (8 rows of K), LBO = the byte
//     distance between the two 64-wide halves (used when N = 128).
//
// The fragment layout.  A wgmma m64nNk16 fp32 accumulator gives warp w of
// the warpgroup rows 16w + g and 16w + g + 8 (lane = 4g + t), and in each
// 8-column block n the columns 8n + 2t and 8n + 2t + 1:
//   d[4n + 0..1] = C[16w + g][8n + 2t ..],  d[4n + 2..3] = C[16w + g + 8][..]
// That is mma.sync m16n8k16's C layout per 16-row slab (flash_common.cuh),
// so the masking and softmax code of the mma.sync kernels carries over, and
// an accumulator re-packed to bf16 (pack_a_frag) is the A operand of an RS
// wgmma with no data movement, as mma.sync's C becomes its A.
//
// Sections of cuda_guide.md followed: "Tensor Map Descriptor (Host Side)"
// and "Tensor Map Creation with cuTensorMapEncodeTiled" (make_bshd_map),
// "__grid_constant__ for TMA Descriptors" (the kernels take their maps by
// value), "TMA Load (PTX)" / "TMA PTX Instruction Format" (tma_load_4d),
// "TMA Store (PTX)" (tma_store_4d), "Bulk Reduce-Add (Atomic
// Accumulation)" (tma_reduce_add_4d, in its tensor-map form),
// "Mbarrier Operations" and "Mbarrier Notes" (mbar_*), "WGMMA Descriptor"
// and "WGMMA Matrix Descriptor (LBO and SBO)" (smem_desc), "WGMMA
// Synchronization" (wgmma_fence/commit/wait), "WGMMA trans_a/trans_b
// Flags" (the kTransA/kTransB template arguments), "Register
// Rebalancing" and "CRITICAL: Warp Specialization Structure for
// setmaxnreg" (reg_alloc/reg_dealloc), "Named Barriers (Hopper)"
// (named_barrier), "B128 Swizzle Pattern" (swizzled_offset) and "Memory
// Fence Required Before Cross-Warpgroup Reads" (fence_proxy_async).
//
// cuTensorMapEncodeTiled is a driver function: it is fetched once through
// the runtime's cudaGetDriverEntryPoint(ByVersion), so the libraries need
// no -lcuda.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nos_hopper {

constexpr int kHeadDim = 128;
constexpr int kHalfCols = 64;           // bf16 columns in one 128-byte row
constexpr float kNegInf = -1e30f;

// ---- host: tensor maps ---------------------------------------------------

using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A map over one [B, S, H, 128] tensor of `elem_bytes`-byte elements
// (bf16 or fp32) read through its element strides (sb, ss, sh; unit
// stride over D): 4-D, innermost first, dims (128, H, S, B), a box of
// (128 / elem_bytes, 1, rows, 1) = 128-byte rows, 128-byte swizzle.  Rows
// past S read as zeros and are not written by a store or a reduction.
// Returns false if the driver refuses the map.
inline bool make_bshd_map(CUtensorMap* map, const void* base, int batch,
                          int seq, int heads, int64_t sb, int64_t ss,
                          int64_t sh, int rows, int elem_bytes = 2) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kHeadDim),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh * elem_bytes),
                                 static_cast<cuuint64_t>(ss * elem_bytes),
                                 static_cast<cuuint64_t>(sb * elem_bytes)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(128 / elem_bytes), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map,
                elem_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                4, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---- device: addresses, barriers, TMA ------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (row, col) of a swizzled [rows x 128] tile whose
// halves are `half_bytes` apart.
__device__ __forceinline__ uint32_t swizzled_offset(int row, int col,
                                                    uint32_t half_bytes) {
  const int half = col >> 6;
  const int chunk = (col >> 3) & 7;
  return half * half_bytes + row * 128 + ((chunk ^ (row & 7)) << 4) +
         ((col & 7) << 1);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Adds a swizzled fp32 box from shared memory into global memory (the
// driver's reduction, one bulk operation per box).
__device__ __forceinline__ void tma_reduce_add_4d(const CUtensorMap* map,
                                                  const void* src, int c0,
                                                  int c1, int c2, int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most kPending committed bulk groups still read shared
// memory.
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending)
               : "memory");
}

__device__ __forceinline__ void tma_store_commit_and_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Orders this thread's generic-proxy shared stores before later
// async-proxy reads (wgmma operands, TMA stores).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int kRegs>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// ---- device: wgmma --------------------------------------------------------

// Descriptor of a 128B-swizzled bf16 operand at shared address `addr`.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= 1ull << 62;  // layout type 1: 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma still in flight.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define NOS_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define NOS_F16(i) NOS_F4(i), NOS_F4(i + 4), NOS_F4(i + 8), NOS_F4(i + 12)
#define NOS_F32(i) NOS_F16(i), NOS_F16(i + 16)
#define NOS_F64 NOS_F32(0), NOS_F32(32)

#define NOS_R32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"
#define NOS_R64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 64, fp32) = (accumulate ? d : 0) + A . B, A and B from shared
// memory; kTransA / kTransB = 1 for an MN-major operand.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " NOS_R32
      ", %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : NOS_F32(0)
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

// d (64 x 128, fp32) = (accumulate ? d : 0) + A . B, both from shared memory.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128_ss(float (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " NOS_R64
      ", %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : NOS_F64
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

// d (64 x 128, fp32) = (accumulate ? d : 0) + A . B with A (64 x 16 bf16)
// from registers in the fragment layout above and B from shared memory.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128_rs(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " NOS_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : NOS_F64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(kTransB));
}

#undef NOS_F4
#undef NOS_F16
#undef NOS_F32
#undef NOS_F64
#undef NOS_R32
#undef NOS_R64

// 2^x on the SFU (ex2.approx), results below 2^-126 flushed to zero: one
// instruction where expf is several.  The kernels compute exp(a - b) as
// exp2(a * log2(e) - b * log2(e)) with the products fused.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand of k-step kk (columns 16kk .. 16kk + 15) re-packed to bf16
// from an fp32 accumulator d in the fragment layout.
template <int N>
__device__ __forceinline__ void pack_a_frag(uint32_t (&a)[4],
                                            const float (&d)[N], int kk) {
  a[0] = pack_bf16x2(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16x2(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16x2(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16x2(d[8 * kk + 6], d[8 * kk + 7]);
}

}  // namespace nos_hopper
