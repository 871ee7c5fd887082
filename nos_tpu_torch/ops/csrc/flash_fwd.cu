// Flash-attention forward for Hopper (sm_90a): o = softmax(q k^T / sqrt(D)) v
// and the row log-sum-exp, in bf16 with fp32 statistics.
//
// Replaces: the Pallas TPU kernel `_fwd_kernel` in nos_tpu/ops/attention.py
// (launched by `_flash_forward`).  Same function, same numerics:
//   s = (q . k^T, fp32 accumulation) * D^-1/2; causal entries above the
//   diagonal get -1e30 added; running max m and sum l in fp32; p rounded to
//   bf16 before p . v with fp32 accumulation; o = acc / max(l, 1e-20);
//   lse = m + log(max(l, 1e-20)).
//
// What bounds it: memory.  At the serving shape (B 8, S 512, H 8, D 128,
// causal, bf16) the kernel must move ~34 MB of q/k/v/o against ~4.3 GFLOP,
// ~10 us of HBM traffic at 3.35 TB/s against ~4 us of bf16 tensor-core work,
// so the score matrix never leaves the SM: one CTA keeps a 64-row q tile in
// registers and streams the k/v tiles of its (batch, head) through shared
// memory, double-buffered with cp.async so the next tile's load overlaps
// this tile's two matmuls.  q/k/v/o are read and written in their
// [B, S, H, D] layout through strides, so no transpose copy is made.
//
// Design (simple first; wgmma, TMA, warp specialisation and reading k/v
// once per GQA group are later work):
// - grid (ceil(Sq/64), H, B), 4 warps per CTA, 16 q rows per warp; the
//   in-CTA loop over k tiles replaces the Pallas grid's sequential k axis,
//   so nothing is carried across CTAs.  Under causal the loop stops at the
//   diagonal tile (the TPU kernel's `_on_or_below_diag` skip); the heaviest
//   q tiles are launched first.
// - mma.sync m16n8k16 bf16 -> fp32.  Q and K fragments come from ldmatrix,
//   V from ldmatrix.trans; the S accumulator is re-packed in registers as
//   the A operand of P . V.  m and l stay in fp32 registers (two rows per
//   thread); the TPU kernel's lane replication has no counterpart.
// - shared rows padded to 136 elements (272 bytes) so the eight rows of an
//   ldmatrix fall in distinct banks.  Q + 2 K + 2 V tiles = 85 KB dynamic
//   shared memory, two CTAs per SM.
// - ragged tails: rows past Sk or Sq are zero-filled by cp.async, keys past
//   Sk are set to -1e30, rows past Sq are not stored.  Any length works.

#include "flash_common.cuh"

namespace {

using namespace nos_flash;

constexpr int kBlockM = kTileRows;       // q rows per CTA
constexpr int kBlockN = kTileRows;       // keys per k/v tile
constexpr int kSmemBytes = 5 * kTileElems * 2;  // Q, K[2], V[2]

__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int heads, int seq_q, int seq_k, int64_t q_sb,
                     int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                     int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                     int64_t o_sb, int64_t o_ss, int64_t o_sh, float scale,
                     int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + kTileElems;       // two buffers
  __nv_bfloat16* sV = sK + 2 * kTileElems;   // two buffers

  const int q_tile = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = q_tile * kBlockM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row within the 8-row group
  const int t = lane & 3;   // fragment column pair

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;

  int n_tiles = (seq_k + kBlockN - 1) / kBlockN;
  if (causal) n_tiles = min(n_tiles, (row0 + kBlockM - 1) / kBlockN + 1);

  load_tile(sQ, qb, q_ss, row0, seq_q);
  load_tile(sK, kb, k_ss, 0, seq_k);
  load_tile(sV, vb, v_ss, 0, seq_k);
  cp_async_commit();

  // This thread's rows: warp*16 + g (index 0) and warp*16 + g + 8 (index 1).
  const int q_row0 = row0 + warp * 16 + g;
  uint32_t qf[kHeadDim / 16][4];
  float acc[kHeadDim / 8][4];
#pragma unroll
  for (int d = 0; d < kHeadDim / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile(sK + (buf ^ 1) * kTileElems, kb, k_ss, (j + 1) * kBlockN,
                seq_k);
      load_tile(sV + (buf ^ 1) * kTileElems, vb, v_ss, (j + 1) * kBlockN,
                seq_k);
    }
    cp_async_commit();  // possibly empty: keeps wait_group 1 uniform
    cp_async_wait_one();
    __syncthreads();

    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk)
        frag_a(qf[kk], sQ, kStride, warp * 16, kk * 16, lane);
    }

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys.
    const __nv_bfloat16* sKb = sK + buf * kTileElems;
    float s[kBlockN / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kBlockN / 16; ++np) {
        uint32_t bk[4];
        frag_b(bk, sKb, kStride, np * 16, kk * 16, lane);
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // Scale, mask, online softmax.
    const int key0 = j * kBlockN;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + n * 8 + 2 * t + (e & 1);
        const int row = q_row0 + (e >> 1) * 8;
        float x = s[n][e] * scale;
        if (causal && key > row) x += kNegInf;
        if (key >= seq_k) x = kNegInf;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], m_new[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_new[i] = fmaxf(m_run[i], mx[i]);
      alpha[i] = __expf(m_run[i] - m_new[i]);
      m_run[i] = m_new[i];
      l_run[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = __expf(s[n][e] - m_new[e >> 1]);
        l_run[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int d = 0; d < kHeadDim / 8; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }

    // O += P V: P (rounded to bf16) is the A operand straight from S.
    const __nv_bfloat16* sVb = sV + buf * kTileElems;
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t pa[4];
      pack_a(pa, s, kk);
#pragma unroll
      for (int dp = 0; dp < kHeadDim / 16; ++dp) {
        uint32_t bv[4];
        frag_b_trans(bv, sVb, kStride, kk * 16, dp * 16, lane);
        mma_bf16(acc[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites this buffer
  }

  // Epilogue: full row sums, o = acc / max(l, 1e-20), lse = m + log l.
  float l_fin[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_fin[i] = fmaxf(l, 1e-20f);
  }
  if (t == 0) {
    float* lse_bh = lse + (static_cast<int64_t>(b) * heads + h) * seq_q;
    if (q_row0 < seq_q) lse_bh[q_row0] = m_run[0] + logf(l_fin[0]);
    if (q_row0 + 8 < seq_q) lse_bh[q_row0 + 8] = m_run[1] + logf(l_fin[1]);
  }

  // Stage the o tile in sQ (each warp owns its 16 rows there), then store
  // it with 16-byte coalesced writes.
  const int r_local = warp * 16 + g;
#pragma unroll
  for (int d = 0; d < kHeadDim / 8; ++d) {
    const int c = d * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(sQ + r_local * kStride + c) =
        pack_bf16(acc[d][0] / l_fin[0], acc[d][1] / l_fin[0]);
    *reinterpret_cast<uint32_t*>(sQ + (r_local + 8) * kStride + c) =
        pack_bf16(acc[d][2] / l_fin[1], acc[d][3] / l_fin[1]);
  }
  __syncthreads();
  store_tile(o + b * o_sb + h * o_sh, sQ, o_ss, row0, seq_q);
}

}  // namespace

// Launch on `stream`.  Pointers are device pointers in [B, S, H, D] layout
// with unit stride over D (D must be 128, rows 16-byte aligned); strides are
// in elements.  lse is a contiguous fp32 [B, H, Sq].  Causal requires
// seq_q == seq_k.  Returns cudaGetLastError() after the launch.
extern "C" int nos_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int batch, int heads,
                             int seq_q, int seq_k, int64_t q_sb, int64_t q_ss,
                             int64_t q_sh, int64_t k_sb, int64_t k_ss,
                             int64_t k_sh, int64_t v_sb, int64_t v_ss,
                             int64_t v_sh, int64_t o_sb, int64_t o_ss,
                             int64_t o_sh, float scale, int causal,
                             void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq_q + kBlockM - 1) / kBlockM, heads, batch);
  flash_fwd_kernel<<<grid, kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), heads, seq_q, seq_k, q_sb, q_ss, q_sh, k_sb,
      k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale, causal);
  return static_cast<int>(cudaGetLastError());
}
