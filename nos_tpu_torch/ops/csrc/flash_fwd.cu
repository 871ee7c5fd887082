// Flash-attention forward for Hopper (sm_90a): o = softmax(q k^T / sqrt(D)) v
// and the row log-sum-exp, in bf16 with fp32 statistics (K1).
//
// Replaces: the Pallas TPU kernel `_fwd_kernel` in nos_tpu/ops/attention.py
// (launched by `_flash_forward`).  Same function, same numerics:
//   s = (q . k^T, fp32 accumulation) * D^-1/2; causal entries above the
//   diagonal get -1e30 added; running max m and sum l in fp32; p rounded to
//   bf16 before p . v with fp32 accumulation; o = acc / max(l, 1e-20);
//   lse = m + log(max(l, 1e-20)).
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): at the
// training shape (B 8, S 2048, H 8, D 128, causal) operations, 6.9e10 FLOP
// = 0.0695 ms against 0.01 ms of bytes; at the serving shape (B 8, S 512)
// bytes, ~34 MB of q/k/v/o = 0.0101 ms against 0.0043 ms of operations.
// The score matrix never leaves the SM.
//
// Design (warp-specialised, wgmma + TMA; hopper_common.cuh holds the
// machinery and its layout notes):
// - grid (ceil(Sq/128), H, B), 384 threads: two consumer warpgroups own 64
//   q rows each, and one producer warpgroup, of which one thread starts
//   every load.  Causal runs take the heaviest (last) q tiles first; when
//   K and V fit in the L2 the grid is (H, B, tiles), so that the heaviest
//   tiles of every (b, h) go first, else (tiles, H, B), which keeps a
//   (b, h)'s K/V in L2.  On an H100 SXM at 700 W (50 MB of L2;
//   scripts/ab_flash_kernel.py, causal, B 8, H 8) the first order won at
//   S 512 (K/V 17 MB: 0.0241 against 0.0270 ms) and S 1024 (34 MB: 0.0612
//   against 0.0644 ms), the second at S 2048 (67 MB: 0.165 against 0.174
//   ms).  Those three shapes are all that bound the threshold: where the
//   orders cross between 34 and 67 MB is not measured.
// - The producer loads the CTA's 128 Q rows once, then streams 128-key K
//   and V tiles by TMA into a two-stage ring (128B-swizzled, zero-filled
//   past Sk), K and V each on their own full/empty mbarriers, so S can
//   start before V lands and K's slot is refilled as soon as S is done.
//   Each CTA reads its (b, h)'s K/V once per 128 q rows, not per 64.
// - S = Q K^T is 8 SS wgmma m64n128k16 per consumer (Q and K both
//   K-major); P is re-packed from the accumulator as bf16 A fragments and
//   O += P V is 8 RS wgmma m64n128k16 with V MN-major.  The loop is
//   software-pipelined: S_j and P_{j-1} V_{j-1} are started together, and
//   the softmax of S_j runs while P_{j-1} V_{j-1} is on the tensor cores.
// - The softmax (softmax_tile) works on the raw scores: the row max is
//   taken before scaling (the scale is positive) and p = exp2(s c - m c)
//   with c = D^-1/2 log2(e) is one FFMA and one ex2.approx.ftz per score;
//   the mask is compiled into a second instance that only the diagonal or
//   ragged tile runs.  The first build of this loop spent ~20
//   instructions per score (expf's denormal path, per-element mask
//   tests); this spends ~5.
// - setmaxnreg: producer 24 registers, consumers 240.
// - o goes through the consumer's own Q tile in shared memory (swizzled
//   16-byte chunks, no bank conflicts) and out by TMA store, which drops
//   rows past Sq; lse (= m D^-1/2 + log l) is written directly.
// - Shared memory: Q 32 KB + 2 stages x (K 32 KB + V 32 KB) = 160 KB, one
//   CTA per SM.  A third stage measured no faster; nor did taking turns
//   between the consumers with named barriers (FA3's ping-pong).
//
// Tiles.  The body is flash_fwd_kernel<kConsumers, kBlockN>: 64 q rows per
// consumer warpgroup, kBlockN keys per K/V tile.  Two are compiled, and
// nos_flash_fwd takes the tile as (block_q, block_k) = (q rows per CTA,
// keys per tile):
// - (128, 128) = <2, 128>, the default above: 160 KB, one CTA per SM.
// - (64, 64) = <1, 64>: one consumer, 64-key tiles, 2 stages: Q 16 KB +
//   2 x (K 16 KB + V 16 KB) = 80 KB, two CTAs per SM (setmaxnreg 24 /
//   232, hopper_common.cuh's CtaShape).  Twice the CTAs of the default,
//   so twice the K/V reads from L2; a 64-row CTA with 128-key tiles
//   would need 144 KB, one CTA per SM, and half the default's consumers
//   an SM.  On an H100 SXM at 700 W (scripts/sweep_flash_torch.py, B8
//   H8) it won causal at S512 (0.0225 against 0.0243 ms) and S1024
//   (0.0605 against 0.0611) and lost everywhere else, by 2.6% at S2048
//   causal up to 24% at S8192 full.
// Any other tile returns cudaErrorInvalidValue.
//
// What held the previous (mma.sync) body back, and what this does about
// it: mma.sync with an ldmatrix of every fragment per k-step (now wgmma
// from swizzled shared tiles), 64-row q tiles re-streaming K/V per 64
// rows (now 128), a synchronous cp.async double buffer with two
// __syncthreads per tile (now a TMA ring on mbarriers, loads overlapping
// both consumers' math), and no producer/consumer split (now one).
//
// ptxas (sm_90a, CUDA 12.9): 168 registers at entry for (128, 128) (then
// 24 / 240 by setmaxnreg), no spill; chip_smoke.py's build phase reports
// both tiles.

#include "hopper_common.cuh"

namespace {

using namespace nos_hopper;

constexpr int kStages = 2;

// The tile's sizes and shared-memory layout: Q (one 64-row tile per
// consumer), the K and V rings, the mbarriers.
template <int kConsumers, int kBlockN>
struct Smem {
  static constexpr int kBlockM = 64 * kConsumers;        // q rows per CTA
  static constexpr uint32_t kQTileBytes = 64 * kHeadDim * 2;  // one WG's Q
  static constexpr uint32_t kQHalf = 64 * 128;                // bytes
  static constexpr uint32_t kKvBytes = kBlockN * kHeadDim * 2;  // one tile
  static constexpr uint32_t kKvHalf = kBlockN * 128;
  static constexpr uint32_t kQOff = 0;
  static constexpr uint32_t kKOff = kQOff + kConsumers * kQTileBytes;
  static constexpr uint32_t kVOff = kKOff + kStages * kKvBytes;
  static constexpr uint32_t kBarOff = kVOff + kStages * kKvBytes;
  static constexpr int kNumBars = 1 + 4 * kStages;
  static constexpr int kBytes = kBarOff + kNumBars * 8 + 1024;  // + align
};

// The online softmax of one S tile (64 rows x kBlockN keys per consumer,
// raw scores q . k in the accumulator layout), in place: s becomes p.
// m_run is the running row max of the raw scores (the max of the scaled
// scores is m_run * D^-1/2, since the scale is positive); p = exp(s D^-1/2
// - m) is computed as exp2(s c - m c) with c = D^-1/2 log2(e).  With
// kMasked, keys above the diagonal (causal) or past Sk are set to -1e30
// first.  alpha gets the factor that rescales O and l.
template <bool kMasked, int kBlockN>
__device__ __forceinline__ void softmax_tile(float (&s)[kBlockN / 2],
                                             float (&m_run)[2],
                                             float (&l_run)[2],
                                             float (&alpha)[2], float c,
                                             int key0, int row_a, int t,
                                             int seq_k, int causal) {
  float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kMasked) {
        const int key = key0 + n * 8 + 2 * t + (e & 1);
        const int row = row_a + (e >> 1) * 8;
        if ((causal && key > row) || key >= seq_k) s[4 * n + e] = kNegInf;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * n + e]);
    }
  }
  float mc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = exp2_ftz((m_run[i] - mx[i]) * c);
    m_run[i] = mx[i];
    l_run[i] *= alpha[i];
    mc[i] = mx[i] * c;
  }
#pragma unroll
  for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * n + e] = exp2_ftz(fmaf(s[4 * n + e], c, -mc[e >> 1]));
      l_run[e >> 1] += s[4 * n + e];
    }
  }
}

template <int kConsumers, int kBlockN>
__global__ void __launch_bounds__(CtaShape<kConsumers>::kThreads,
                                  CtaShape<kConsumers>::kMinBlocks)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap o_map,
                     float* __restrict__ lse, int heads, int seq_q,
                     int seq_k, float scale, int causal, int tiles_outer) {
  using L = Smem<kConsumers, kBlockN>;
  using Cta = CtaShape<kConsumers>;
  constexpr int kBlockM = L::kBlockM;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  // Heaviest (last) q tiles first: of every (b, h) at once when the grid
  // is (H, B, tiles), within each (b, h) when it is (tiles, H, B).
  const int q_tile = tiles_outer ? gridDim.z - 1 - blockIdx.z
                                 : gridDim.x - 1 - blockIdx.x;
  const int h = tiles_outer ? blockIdx.x : blockIdx.y;
  const int b = tiles_outer ? blockIdx.y : blockIdx.z;
  const int m0 = q_tile * kBlockM;
  int n_tiles = (seq_k + kBlockN - 1) / kBlockN;
  if (causal) n_tiles = min(n_tiles, (m0 + kBlockM - 1) / kBlockN + 1);

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], kConsumers * 4);  // one arrive per warp
      mbar_init(&v_empty[s], kConsumers * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer ----
    reg_dealloc<Cta::kProducerRegs>();
    if (tid == 0) {
      mbar_expect_tx(q_full, kConsumers * L::kQTileBytes);
      for (int w = 0; w < kConsumers; ++w)
        for (int half = 0; half < 2; ++half)
          tma_load_4d(smem + L::kQOff + w * L::kQTileBytes + half * L::kQHalf,
                      &q_map, q_full, half * kHalfCols, h, m0 + 64 * w, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        if (j >= kStages) mbar_wait(&k_empty[st], ((j / kStages) - 1) & 1);
        mbar_expect_tx(&k_full[st], L::kKvBytes);
        for (int half = 0; half < 2; ++half)
          tma_load_4d(smem + L::kKOff + st * L::kKvBytes + half * L::kKvHalf,
                      &k_map, &k_full[st], half * kHalfCols, h, j * kBlockN,
                      b);
        if (j >= kStages) mbar_wait(&v_empty[st], ((j / kStages) - 1) & 1);
        mbar_expect_tx(&v_full[st], L::kKvBytes);
        for (int half = 0; half < 2; ++half)
          tma_load_4d(smem + L::kVOff + st * L::kKvBytes + half * L::kKvHalf,
                      &v_map, &v_full[st], half * kHalfCols, h, j * kBlockN,
                      b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns q rows m0 + 64 wg .. + 63 ----
    reg_alloc<Cta::kConsumerRegs>();
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int row_a = m0 + 64 * wg + 16 * warp + g;  // and row_a + 8
    unsigned char* sq = smem + L::kQOff + wg * L::kQTileBytes;
    const uint32_t q_addr = smem_u32(sq);

    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m_run[2] = {kNegInf, kNegInf};
    float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

    mbar_wait(q_full, 0);
    float s[kBlockN / 2];
    uint32_t pa[kBlockN / 16][4];
    // S_j = Q K_j^T into s (64 rows x kBlockN keys per consumer).
    auto start_s = [&](int j) {
      const int st = j % kStages;
      const uint32_t k_addr = smem_u32(smem + L::kKOff + st * L::kKvBytes);
      mbar_wait(&k_full[st], (j / kStages) & 1);
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_m64nN_ss<kBlockN, 0, 0>(
            s, smem_desc(q_addr + (kk / 4) * L::kQHalf + off, 0, 1024),
            smem_desc(k_addr + (kk / 4) * L::kKvHalf + off, 0, 1024),
            kk > 0);
      }
      wgmma_commit();
    };
    // O += P_j V_j, P from registers, V MN-major (16 keys per k-step).
    auto start_pv = [&](int j) {
      const int st = j % kStages;
      const uint32_t v_addr = smem_u32(smem + L::kVOff + st * L::kKvBytes);
      mbar_wait(&v_full[st], (j / kStages) & 1);
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
        wgmma_m64n128_rs<1>(
            o, pa[kk], smem_desc(v_addr + kk * 16 * 128, L::kKvHalf, 1024),
            1);
      wgmma_commit();
    };
    const float c = scale * kLog2e;
    float alpha[2];
    auto softmax = [&](int j) {
      if ((causal && j == n_tiles - 1) || (j + 1) * kBlockN > seq_k)
        softmax_tile<true, kBlockN>(s, m_run, l_run, alpha, c, j * kBlockN,
                                    row_a, t, seq_k, causal);
      else
        softmax_tile<false, kBlockN>(s, m_run, l_run, alpha, c, j * kBlockN,
                                     row_a, t, seq_k, causal);
    };

    // Tile 0, then per tile j: S_j and P_{j-1} V_{j-1} go to the tensor
    // cores together, and the softmax of S_j runs while P_{j-1} V_{j-1}
    // is in flight.
    wgmma_fence();
    start_s(0);
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(&k_empty[0]);
    softmax(0);
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) pack_a_frag(pa[kk], s, kk);
    for (int j = 1; j < n_tiles; ++j) {
      fence_regs(o);
      wgmma_fence();
      start_s(j);
      start_pv(j - 1);
      wgmma_wait<1>();
      fence_regs(s);
      if (lane == 0) mbar_arrive(&k_empty[j % kStages]);
      softmax(j);
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(&v_empty[(j - 1) % kStages]);
#pragma unroll
      for (int n = 0; n < kHeadDim / 8; ++n) {
        o[4 * n + 0] *= alpha[0];
        o[4 * n + 1] *= alpha[0];
        o[4 * n + 2] *= alpha[1];
        o[4 * n + 3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) pack_a_frag(pa[kk], s, kk);
    }
    fence_regs(o);
    wgmma_fence();
    start_pv(n_tiles - 1);
    wgmma_wait<0>();
    fence_regs(o);

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
      if (row_a < seq_q) lse_bh[row_a] = m_run[0] * scale + logf(l_fin[0]);
      if (row_a + 8 < seq_q)
        lse_bh[row_a + 8] = m_run[1] * scale + logf(l_fin[1]);
    }
    // o into this consumer's own Q tile (its S products are done), then
    // out by TMA store, which drops rows past Sq.
    const int r = 16 * warp + g;
#pragma unroll
    for (int n = 0; n < kHeadDim / 8; ++n) {
      const int c = 8 * n + 2 * t;
      *reinterpret_cast<uint32_t*>(sq + swizzled_offset(r, c, L::kQHalf)) =
          pack_bf16x2(o[4 * n] / l_fin[0], o[4 * n + 1] / l_fin[0]);
      *reinterpret_cast<uint32_t*>(sq + swizzled_offset(r + 8, c, L::kQHalf)) =
          pack_bf16x2(o[4 * n + 2] / l_fin[1], o[4 * n + 3] / l_fin[1]);
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (tid == 0) {
      for (int half = 0; half < 2; ++half)
        tma_store_4d(&o_map, sq + half * L::kQHalf, half * kHalfCols, h,
                     m0 + 64 * wg, b);
      tma_store_commit_and_wait();
    }
  }
}

template <int kConsumers, int kBlockN>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int batch, int heads, int seq_q, int seq_k,
               int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
               int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
               int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
               float scale, int causal, void* stream) {
  using L = Smem<kConsumers, kBlockN>;
  constexpr int kThreads = CtaShape<kConsumers>::kThreads;
  CUtensorMap q_map, k_map, v_map, o_map;
  if (!make_bshd_map(&q_map, q, batch, seq_q, heads, q_sb, q_ss, q_sh, 64) ||
      !make_bshd_map(&k_map, k, batch, seq_k, heads, k_sb, k_ss, k_sh,
                     kBlockN) ||
      !make_bshd_map(&v_map, v, batch, seq_k, heads, v_sb, v_ss, v_sh,
                     kBlockN) ||
      !make_bshd_map(&o_map, o, batch, seq_q, heads, o_sb, o_ss, o_sh, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<kConsumers, kBlockN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Launch order: when K and V fit in the L2 cache, every (b, h)'s
  // heaviest q tiles go first, which shortens the causal tail; larger
  // K/V keep each (b, h)'s tiles together so their K/V stay in L2.
  int device = 0, l2_bytes = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&l2_bytes, cudaDevAttrL2CacheSize, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (seq_q + L::kBlockM - 1) / L::kBlockM;
  const double kv_bytes = 4.0 * batch * heads * seq_k * kHeadDim;
  const int tiles_outer = kv_bytes <= l2_bytes && tiles <= 65535;
  const dim3 grid = tiles_outer ? dim3(heads, batch, tiles)
                                : dim3(tiles, heads, batch);
  flash_fwd_kernel<kConsumers, kBlockN>
      <<<grid, kThreads, L::kBytes, static_cast<cudaStream_t>(stream)>>>(
          q_map, k_map, v_map, o_map, static_cast<float*>(lse), heads, seq_q,
          seq_k, scale, causal, tiles_outer);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`.  Pointers are device pointers in [B, S, H, D] layout
// with unit stride over D (D must be 128, strides multiples of 8 elements,
// 16-byte aligned starts); strides are in elements.  lse is a contiguous
// fp32 [B, H, Sq].  Causal requires seq_q == seq_k.  (block_q, block_k)
// picks the compiled tile, (128, 128) or (64, 64); any other returns
// cudaErrorInvalidValue, as does a refused tensor map; else
// cudaGetLastError() after the launch.
extern "C" int nos_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int batch, int heads,
                             int seq_q, int seq_k, int64_t q_sb, int64_t q_ss,
                             int64_t q_sh, int64_t k_sb, int64_t k_ss,
                             int64_t k_sh, int64_t v_sb, int64_t v_ss,
                             int64_t v_sh, int64_t o_sb, int64_t o_ss,
                             int64_t o_sh, float scale, int causal,
                             int block_q, int block_k, void* stream) {
  if (block_q == 128 && block_k == 128)
    return launch_fwd<2, 128>(q, k, v, o, lse, batch, heads, seq_q, seq_k,
                              q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                              v_sh, o_sb, o_ss, o_sh, scale, causal, stream);
  if (block_q == 64 && block_k == 64)
    return launch_fwd<1, 64>(q, k, v, o, lse, batch, heads, seq_q, seq_k,
                             q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                             v_sh, o_sb, o_ss, o_sh, scale, causal, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
