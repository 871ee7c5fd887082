// Split flash-attention backward for Hopper (sm_90a): a dq kernel and a
// dk/dv kernel, 3 + 4 = 7 matrix products per (q tile, k tile) pair and no
// cross-CTA sum, so both are deterministic.
//
// Replaces: the Pallas TPU kernels `_dq_kernel` (nos_flash_dq) and
// `_dkv_kernel` (nos_flash_dkv) in nos_tpu/ops/attention.py, launched by
// `_flash_backward`: the backward that NOS_TPU_FLASH_BWD=split selects
// and that long sequences take when the fused backward's dq partials
// would exceed FUSED_PARTIAL_BUDGET.
//
// What bounds them: operations.  At the training shape (B 8, S 2048, H 8,
// D 128, causal, bf16) the dq kernel does 1.03e11 FLOP against ~169 MB
// and the dk/dv kernel 1.37e11 FLOP against ~202 MB.
//
// dq kernel design: grid (ceil(Sq/64), H, B), 4 warps, 16 q rows per warp,
// the heaviest (last) q tiles first.  The CTA keeps Q and dO in shared
// memory and streams the k/v tiles up to the diagonal through it,
// double-buffered with cp.async, like the forward kernel.  Per k tile a
// warp computes S = Q K^T and dP = dO V^T in registers, forms
// dS = exp(scale * S + mask - lse) * (dP - delta), and re-packs dS (bf16)
// as the A operand of dq += dS K.  dq = D^-1/2 * dq at the end, staged in
// shared memory and stored with 16-byte writes.  The TPU numerics: fp32
// scores and statistics, p in fp32, ds rounded to bf16 before its product.
//
// The dk/dv kernel is flash_bwd_kv_kernel in flash_bwd_kv.cuh, the first
// (mma.sync) fused backward without its dq share.

#include "flash_bwd_kv.cuh"

namespace {

using namespace nos_flash;

constexpr int kDqSmemBytes = 6 * kTileElems * 2;  // Q, dO, K[2], V[2]

__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int heads, int seq_q,
                    int seq_k, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                    int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss,
                    int64_t o_sh, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sdO = sQ + kTileElems;
  __nv_bfloat16* sK = sdO + kTileElems;      // two buffers
  __nv_bfloat16* sV = sK + 2 * kTileElems;   // two buffers

  const int q_tile = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = q_tile * kTileRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  const __nv_bfloat16* ob = dout + b * o_sb + h * o_sh;

  int n_tiles = (seq_k + kTileRows - 1) / kTileRows;
  if (causal) n_tiles = min(n_tiles, (row0 + kTileRows - 1) / kTileRows + 1);

  load_tile(sQ, qb, q_ss, row0, seq_q);
  load_tile(sdO, ob, o_ss, row0, seq_q);
  load_tile(sK, kb, k_ss, 0, seq_k);
  load_tile(sV, vb, v_ss, 0, seq_k);
  cp_async_commit();

  // This thread's rows: q_row (accumulator rows g) and q_row + 8.
  const int q_row = row0 + warp * 16 + g;
  const int64_t stat0 = (static_cast<int64_t>(b) * heads + h) * seq_q;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q_row + 8 * i;
    lse_r[i] = r < seq_q ? lse[stat0 + r] : 0.f;
    delta_r[i] = r < seq_q ? delta[stat0 + r] : 0.f;
  }
  float acc[kHeadDim / 8][4];
#pragma unroll
  for (int d = 0; d < kHeadDim / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile(sK + (buf ^ 1) * kTileElems, kb, k_ss, (j + 1) * kTileRows,
                seq_k);
      load_tile(sV + (buf ^ 1) * kTileElems, vb, v_ss, (j + 1) * kTileRows,
                seq_k);
    }
    cp_async_commit();  // possibly empty: keeps wait_group 1 uniform
    cp_async_wait_one();
    __syncthreads();
    const __nv_bfloat16* sKb = sK + buf * kTileElems;
    const __nv_bfloat16* sVb = sV + buf * kTileElems;

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys per warp.
    float s[kTileRows / 8][4], dp[kTileRows / 8][4];
#pragma unroll
    for (int n = 0; n < kTileRows / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
      uint32_t qa[4], oa[4];
      frag_a(qa, sQ, kStride, warp * 16, kk * 16, lane);
      frag_a(oa, sdO, kStride, warp * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < kTileRows / 16; ++np) {
        uint32_t bk[4], bv[4];
        frag_b(bk, sKb, kStride, np * 16, kk * 16, lane);
        mma_bf16(s[2 * np], qa, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
        frag_b(bv, sVb, kStride, np * 16, kk * 16, lane);
        mma_bf16(dp[2 * np], oa, bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], oa, bv[2], bv[3]);
      }
    }

    // dS = P (dP - delta), P = exp(scale * S + mask - lse); kept in s.
    const int key0 = j * kTileRows;
#pragma unroll
    for (int n = 0; n < kTileRows / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + n * 8 + 2 * t + (e & 1);
        const int row = q_row + (e >> 1) * 8;
        float x = s[n][e] * scale;
        if (causal && key > row) x += kNegInf;
        const float p = (key < seq_k && row < seq_q)
                            ? __expf(x - lse_r[e >> 1])
                            : 0.f;
        s[n][e] = p * (dp[n][e] - delta_r[e >> 1]);
      }
    }

    // dq += dS K (dS rounded to bf16 as the A operand).
#pragma unroll
    for (int kk = 0; kk < kTileRows / 16; ++kk) {
      uint32_t da[4];
      pack_a(da, s, kk);
#pragma unroll
      for (int dc = 0; dc < kHeadDim / 16; ++dc) {
        uint32_t bk[4];
        frag_b_trans(bk, sKb, kStride, kk * 16, dc * 16, lane);
        mma_bf16(acc[2 * dc], da, bk[0], bk[1]);
        mma_bf16(acc[2 * dc + 1], da, bk[2], bk[3]);
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites this buffer
  }

  // dq = D^-1/2 * acc, staged in sQ (each warp owns its 16 rows there).
  stage_rows(sQ, warp * 16, acc, scale, lane);
  __syncthreads();
  const int64_t row_stride = static_cast<int64_t>(heads) * kHeadDim;
  store_tile(dq + static_cast<int64_t>(b) * seq_q * row_stride + h * kHeadDim,
             sQ, row_stride, row0, seq_q);
}

}  // namespace

// Pointers are device pointers; q, k, v and dout are [B, S, H, D] with
// unit stride over D (D must be 128, rows 16-byte aligned), strides in
// elements.  lse and delta are contiguous fp32 [B, H, Sq]; dq is a
// contiguous bf16 [B, Sq, H, D].  Causal requires seq_q == seq_k.
// Returns cudaGetLastError() after the launch.
extern "C" int nos_flash_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int batch,
                            int heads, int seq_q, int seq_k, int64_t q_sb,
                            int64_t q_ss, int64_t q_sh, int64_t k_sb,
                            int64_t k_ss, int64_t k_sh, int64_t v_sb,
                            int64_t v_ss, int64_t v_sh, int64_t o_sb,
                            int64_t o_ss, int64_t o_sh, float scale,
                            int causal, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDqSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq_q + kTileRows - 1) / kTileRows, heads, batch);
  flash_dq_kernel<<<grid, kThreads, kDqSmemBytes,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), heads, seq_q, seq_k, q_sb, q_ss, q_sh,
      k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// As nos_flash_dq's arguments, with dk and dv contiguous bf16 [B, Sk, H, D]
// in place of dq.
extern "C" int nos_flash_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv,
                             int batch, int heads, int seq_q, int seq_k,
                             int64_t q_sb, int64_t q_ss, int64_t q_sh,
                             int64_t k_sb, int64_t k_ss, int64_t k_sh,
                             int64_t v_sb, int64_t v_ss, int64_t v_sh,
                             int64_t o_sb, int64_t o_ss, int64_t o_sh,
                             float scale, int causal, void* stream) {
  return launch_bwd_kv(q, k, v, dout, lse, delta, dk, dv, batch, heads,
                       seq_q, seq_k, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                       v_ss, v_sh, o_sb, o_ss, o_sh, scale, causal, stream);
}
