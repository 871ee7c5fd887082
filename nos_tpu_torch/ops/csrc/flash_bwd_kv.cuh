// The flash-attention backward over one k/v tile: dk and dv for 64 keys,
// and (with kDq) this tile's share of dq, added into an fp32 buffer.
// Instantiated by flash_bwd.cu (kDq = true: the fused backward, the port
// of `_fused_bwd_kernel`) and flash_bwd_split.cu (kDq = false: the port
// of `_dkv_kernel`), both in nos_tpu/ops/attention.py.
//
// The numerics are the TPU kernels': s = (q . k^T, fp32) * D^-1/2 with an
// additive -1e30 causal mask; p = exp(s - lse) in fp32; dv += p^T . dO
// with p rounded to bf16; dp = dO . v^T; ds = p * (dp - delta) rounded to
// bf16; dk += ds^T . q; dk = D^-1/2 * dk and dv rounded to bf16 at the
// end.  With kDq the tile's dq share D^-1/2 * (ds . k) is added to dq_acc
// with fp32 atomics (the TPU kernel writes it as a bf16 partial per
// k-block because the TPU has no atomics; see PERF.md for the choice).
//
// Design: grid (ceil(Sk/64), H, B), 4 warps, 16 keys per warp.  The CTA
// keeps its K and V tiles in shared memory and its dk/dv accumulators in
// fp32 registers (64 + 64 per thread) for the whole run, and walks the q
// tiles from the diagonal (causal) or from 0, with Q, dO and the row
// statistics double-buffered through cp.async: this in-CTA loop replaces
// the TPU grid's sequential q axis and its VMEM scratch.  Each warp
// computes S^T and dP^T for its keys directly (K and V as the A operand),
// so p^T and ds^T are re-packed in registers as the A operand of the dv
// and dk products.  For dq, ds^T is staged in shared memory and each warp
// then owns 16 q rows of ds . k.  Ragged tails: rows past Sq or Sk are
// zero-filled and their p is set to 0; keys past Sk are not stored.

#pragma once

#include "flash_common.cuh"

namespace nos_flash {

constexpr int kDsStride = kTileRows + 8;  // padded ds^T row [key][q]

template <bool kDq>
constexpr int bwd_kv_smem_bytes() {
  // K, V, Q[2], dO[2] tiles, lse and delta rows, and ds^T with kDq.
  return 6 * kTileElems * 2 + 2 * kTileRows * 4 +
         (kDq ? kTileRows * kDsStride * 2 : 0);
}

template <bool kDq>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_kv_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq_acc,
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
  __nv_bfloat16* sdS = reinterpret_cast<__nv_bfloat16*>(sDelta + kTileRows);

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

    if constexpr (kDq) {
      // Stage dS^T as bf16 [key][q], then warp w adds rows
      // q0 + 16w .. q0 + 16w + 15 of D^-1/2 * dS K into dq_acc, 32
      // columns of D at a time.
      const int r = warp * 16 + g;
#pragma unroll
      for (int n = 0; n < kTileRows / 8; ++n) {
        const int c = n * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(sdS + r * kDsStride + c) =
            pack_bf16(dpt[n][0], dpt[n][1]);
        *reinterpret_cast<uint32_t*>(sdS + (r + 8) * kDsStride + c) =
            pack_bf16(dpt[n][2], dpt[n][3]);
      }
      __syncthreads();
      const int qa = q0 + warp * 16 + g;
      float* dq_a = dq_acc + (static_cast<int64_t>(b) * seq_q + qa) *
                                 heads * kHeadDim + h * kHeadDim;
      float* dq_b = dq_a + 8 * static_cast<int64_t>(heads) * kHeadDim;
#pragma unroll
      for (int dc = 0; dc < kHeadDim / 32; ++dc) {
        float acc[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kTileRows / 16; ++kk) {
          uint32_t a[4];
          frag_a_trans(a, sdS, kDsStride, warp * 16, kk * 16, lane);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t bk[4];
            frag_b_trans(bk, sK, kStride, kk * 16, dc * 32 + np * 16, lane);
            mma_bf16(acc[2 * np], a, bk[0], bk[1]);
            mma_bf16(acc[2 * np + 1], a, bk[2], bk[3]);
          }
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int c = dc * 32 + n * 8 + 2 * t;
          if (qa < seq_q) {
            atomicAdd(dq_a + c, acc[n][0] * scale);
            atomicAdd(dq_a + c + 1, acc[n][1] * scale);
          }
          if (qa + 8 < seq_q) {
            atomicAdd(dq_b + c, acc[n][2] * scale);
            atomicAdd(dq_b + c + 1, acc[n][3] * scale);
          }
        }
      }
    }
    __syncthreads();  // the next iteration overwrites Q, dO, stats and dS^T
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

// Launch over every k tile; dk and dv (and dq_acc with kDq) are
// contiguous [B, S, H, D].
template <bool kDq>
int launch_bwd_kv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq_acc, void* dk, void* dv, int batch, int heads,
                  int seq_q, int seq_k, int64_t q_sb, int64_t q_ss,
                  int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                  int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb,
                  int64_t o_ss, int64_t o_sh, float scale, int causal,
                  void* stream) {
  constexpr int smem = bwd_kv_smem_bytes<kDq>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kv_kernel<kDq>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq_k + kTileRows - 1) / kTileRows, heads, batch);
  flash_bwd_kv_kernel<kDq><<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq_acc), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), heads, seq_q, seq_k, q_sb, q_ss, q_sh,
      k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nos_flash
