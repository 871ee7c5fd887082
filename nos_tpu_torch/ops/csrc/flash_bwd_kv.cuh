// The flash-attention backward over one k/v tile: dk and dv for 64 keys
// (K4, the port of `_dkv_kernel` in nos_tpu/ops/attention.py), launched
// by nos_flash_dkv in flash_bwd_split.cu.  The fused backward (K2) was
// first built on this body and now has its own Hopper design in
// flash_bwd.cu.
//
// The numerics are the TPU kernel's: s = (q . k^T, fp32) * D^-1/2 with an
// additive -1e30 causal mask; p = exp(s - lse) in fp32; dv += p^T . dO
// with p rounded to bf16; dp = dO . v^T; ds = p * (dp - delta) rounded to
// bf16; dk += ds^T . q; dk = D^-1/2 * dk and dv rounded to bf16 at the
// end.
//
// Design: grid (ceil(Sk/64), H, B), 4 warps, 16 keys per warp.  The CTA
// keeps its K and V tiles in shared memory and its dk/dv accumulators in
// fp32 registers (64 + 64 per thread) for the whole run, and walks the q
// tiles from the diagonal (causal) or from 0, with Q, dO and the row
// statistics double-buffered through cp.async: this in-CTA loop replaces
// the TPU grid's sequential q axis and its VMEM scratch.  Each warp
// computes S^T and dP^T for its keys directly (K and V as the A operand),
// so p^T and ds^T are re-packed in registers as the A operand of the dv
// and dk products.  Ragged tails: rows past Sq or Sk are zero-filled and
// their p is set to 0; keys past Sk are not stored.

#pragma once

#include "flash_common.cuh"

namespace nos_flash {

// K, V, Q[2], dO[2] tiles, lse and delta rows.
constexpr int kBwdKvSmemBytes = 6 * kTileElems * 2 + 2 * kTileRows * 4;

__global__ void __launch_bounds__(kThreads)
    flash_bwd_kv_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int heads, int seq_q,
                        int seq_k, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                        int64_t k_sb, int64_t k_ss, int64_t k_sh,
                        int64_t v_sb, int64_t v_ss, int64_t v_sh,
                        int64_t o_sb, int64_t o_ss, int64_t o_sh, float scale,
                        int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + kTileElems;
  __nv_bfloat16* sQ = sV + kTileElems;        // two buffers
  __nv_bfloat16* sdO = sQ + 2 * kTileElems;   // two buffers
  float* sLse = reinterpret_cast<float*>(sdO + 2 * kTileElems);
  float* sDelta = sLse + kTileRows;

  // Under causal the first k tiles see the most q tiles: launch them first.
  const int key0 = blockIdx.x * kTileRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  const __nv_bfloat16* ob = dout + b * o_sb + h * o_sh;
  const int64_t bh = static_cast<int64_t>(b) * heads + h;
  // Threads 0..63 carry lse rows, 64..127 delta rows, one tile ahead.
  const float* stat_src = (tid < kTileRows ? lse : delta) + bh * seq_q;
  float* stat_dst = (tid < kTileRows ? sLse : sDelta) + (tid % kTileRows);

  const int n_q_tiles = (seq_q + kTileRows - 1) / kTileRows;
  const int i0 = causal ? key0 / kTileRows : 0;

  load_tile(sK, kb, k_ss, key0, seq_k);
  load_tile(sV, vb, v_ss, key0, seq_k);
  load_tile(sQ, qb, q_ss, i0 * kTileRows, seq_q);
  load_tile(sdO, ob, o_ss, i0 * kTileRows, seq_q);
  cp_async_commit();
  int stat_row = i0 * kTileRows + tid % kTileRows;
  float stat = stat_row < seq_q ? stat_src[stat_row] : 0.f;

  // This thread's keys: key_a (accumulator rows g) and key_a + 8.
  const int key_a = key0 + warp * 16 + g;
  float dk_acc[kHeadDim / 8][4];
  float dv_acc[kHeadDim / 8][4];
#pragma unroll
  for (int d = 0; d < kHeadDim / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[d][e] = dv_acc[d][e] = 0.f;

  for (int i = i0; i < n_q_tiles; ++i) {
    const int buf = (i - i0) & 1;
    const int q0 = i * kTileRows;
    *stat_dst = stat;  // the previous iteration ended in __syncthreads
    if (i + 1 < n_q_tiles) {
      stat_row += kTileRows;
      stat = stat_row < seq_q ? stat_src[stat_row] : 0.f;
      load_tile(sQ + (buf ^ 1) * kTileElems, qb, q_ss, q0 + kTileRows, seq_q);
      load_tile(sdO + (buf ^ 1) * kTileElems, ob, o_ss, q0 + kTileRows,
                seq_q);
    }
    cp_async_commit();  // possibly empty: keeps wait_group 1 uniform
    cp_async_wait_one();
    __syncthreads();
    const __nv_bfloat16* sQb = sQ + buf * kTileElems;
    const __nv_bfloat16* sdOb = sdO + buf * kTileElems;

    // S^T = K Q^T: 16 keys x 64 queries per warp.
    float st[kTileRows / 8][4];
#pragma unroll
    for (int n = 0; n < kTileRows / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
      uint32_t ka[4];
      frag_a(ka, sK, kStride, warp * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < kTileRows / 16; ++np) {
        uint32_t bq[4];
        frag_b(bq, sQb, kStride, np * 16, kk * 16, lane);
        mma_bf16(st[2 * np], ka, bq[0], bq[1]);
        mma_bf16(st[2 * np + 1], ka, bq[2], bq[3]);
      }
    }

    // P^T = exp(scale * S^T + mask - lse), 0 outside [0, Sk) x [0, Sq).
#pragma unroll
    for (int n = 0; n < kTileRows / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key_a + (e >> 1) * 8;
        const int col = n * 8 + 2 * t + (e & 1);
        float x = st[n][e] * scale;
        if (causal && key > q0 + col) x += kNegInf;
        st[n][e] = (key < seq_k && q0 + col < seq_q)
                       ? __expf(x - sLse[col])
                       : 0.f;
      }
    }

    // dV += P^T dO (P^T rounded to bf16 as the A operand).
#pragma unroll
    for (int kk = 0; kk < kTileRows / 16; ++kk) {
      uint32_t pa[4];
      pack_a(pa, st, kk);
#pragma unroll
      for (int dp = 0; dp < kHeadDim / 16; ++dp) {
        uint32_t bo[4];
        frag_b_trans(bo, sdOb, kStride, kk * 16, dp * 16, lane);
        mma_bf16(dv_acc[2 * dp], pa, bo[0], bo[1]);
        mma_bf16(dv_acc[2 * dp + 1], pa, bo[2], bo[3]);
      }
    }

    // dP^T = V dO^T.
    float dpt[kTileRows / 8][4];
#pragma unroll
    for (int n = 0; n < kTileRows / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
      uint32_t va[4];
      frag_a(va, sV, kStride, warp * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < kTileRows / 16; ++np) {
        uint32_t bo[4];
        frag_b(bo, sdOb, kStride, np * 16, kk * 16, lane);
        mma_bf16(dpt[2 * np], va, bo[0], bo[1]);
        mma_bf16(dpt[2 * np + 1], va, bo[2], bo[3]);
      }
    }

    // dS^T = P^T (dP^T - delta), kept in dpt.
#pragma unroll
    for (int n = 0; n < kTileRows / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[n][e] = st[n][e] * (dpt[n][e] - sDelta[n * 8 + 2 * t + (e & 1)]);

    // dK += dS^T Q (dS^T rounded to bf16 as the A operand).
#pragma unroll
    for (int kk = 0; kk < kTileRows / 16; ++kk) {
      uint32_t da[4];
      pack_a(da, dpt, kk);
#pragma unroll
      for (int dp = 0; dp < kHeadDim / 16; ++dp) {
        uint32_t bq[4];
        frag_b_trans(bq, sQb, kStride, kk * 16, dp * 16, lane);
        mma_bf16(dk_acc[2 * dp], da, bq[0], bq[1]);
        mma_bf16(dk_acc[2 * dp + 1], da, bq[2], bq[3]);
      }
    }

    __syncthreads();  // the next iteration overwrites Q, dO and the stats
  }

  // Epilogue: dk = D^-1/2 * dk and dv, staged in the K and V tiles.
  stage_rows(sK, warp * 16, dk_acc, scale, lane);
  stage_rows(sV, warp * 16, dv_acc, 1.f, lane);
  __syncthreads();
  const int64_t row_stride = static_cast<int64_t>(heads) * kHeadDim;
  const int64_t slice = static_cast<int64_t>(b) * seq_k * row_stride +
                        h * kHeadDim;
  store_tile(dk + slice, sK, row_stride, key0, seq_k);
  store_tile(dv + slice, sV, row_stride, key0, seq_k);
}

// Launch over every k tile; dk and dv are contiguous [B, S, H, D].
inline int launch_bwd_kv(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dk, void* dv, int batch, int heads, int seq_q,
                         int seq_k, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                         int64_t k_sb, int64_t k_ss, int64_t k_sh,
                         int64_t v_sb, int64_t v_ss, int64_t v_sh,
                         int64_t o_sb, int64_t o_ss, int64_t o_sh, float scale,
                         int causal, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBwdKvSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq_k + kTileRows - 1) / kTileRows, heads, batch);
  flash_bwd_kv_kernel<<<grid, kThreads, kBwdKvSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), heads,
      seq_q, seq_k, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb,
      o_ss, o_sh, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nos_flash
