// Split flash-attention backward for Hopper (sm_90a): a dq kernel (K3) and
// a dk/dv kernel (K4), 3 + 4 = 7 matrix products per (q tile, k tile) pair
// and no cross-CTA sum of any kind (no atomics, no reductions): every
// output row is written by one CTA after a loop in a fixed order, so both
// are bitwise deterministic.
//
// Replaces: the Pallas TPU kernels `_dq_kernel` (nos_flash_dq) and
// `_dkv_kernel` (nos_flash_dkv) in nos_tpu/ops/attention.py, launched by
// `_flash_backward`: the backward that NOS_TPU_FLASH_BWD=split selects
// and that long sequences take when the fused backward's dq partials
// would exceed FUSED_PARTIAL_BUDGET.  The numerics are the TPU kernels':
// s = (q . k^T, fp32) * D^-1/2 with an additive -1e30 causal mask;
// p = exp(s - lse) in fp32; ds = p * (dp - delta) rounded to bf16 before
// its product; dq = D^-1/2 * ds . k; dk = D^-1/2 * ds^T . q; dv = p^T . dO
// with p rounded to bf16; fp32 accumulation throughout.
//
// What bounds them on an H100 SXM: operations.  At the training shape
// (B 8, S 2048, H 8, D 128, causal, bf16) K3 does 1.03e11 FLOP = 0.104 ms
// at 989 TFLOP/s against ~169 MB of inputs and outputs (0.050 ms), K4
// 1.37e11 FLOP = 0.139 ms against ~202 MB (0.060 ms).  p, dp and ds never
// reach device memory.
//
// K3 design (flash_dq_kernel, warp-specialised, wgmma + TMA on
// hopper_common.cuh, shaped like K1 in flash_fwd.cu):
// - grid (ceil(Sq/128), H, B) or (H, B, ceil(Sq/128)), 384 threads: two
//   consumer warpgroups own 64 q rows each and keep their dQ accumulator
//   (64 x 128 fp32) in registers; the producer warp loads the CTA's 128 Q
//   and dO rows once (32 KB each), then streams 64-key K and V tiles by
//   TMA into a kStages-deep ring on full/empty mbarriers (128B-swizzled,
//   zero-filled past Sk), stopping at the diagonal under causal, where
//   the first consumer stops one tile earlier than the second.  Each
//   thread reads the lse (times log2 e) and delta of its two rows once.
//   The heaviest (last) q tiles go first, with K1's L2 rule for the grid's
//   order.
// - Per K/V tile and consumer: S = Q K^T and dP = dO V^T are 8 SS wgmma
//   m64n64k16 each (K-major operands, K1's Q K^T descriptors), started
//   together with the previous tile's dQ product; P = exp2(S c - lse
//   log2 e) is one FFMA and one ex2.approx.ftz per entry while dP runs
//   (the mask is a second instance that only diagonal or ragged tiles
//   run; it zeroes keys past Sk and rows past Sq, where the zero-filled
//   tiles would give exp(-lse)); dS = P (dP - delta) is re-packed as bf16
//   A fragments (16 keys per k-step, as K1 repacks P) and dQ += dS K is 4
//   RS wgmma m64n128k16 with K MN-major (K1's P V layout).  A stage is
//   released once the dQ product that reads its K is done.
// - Epilogue: D^-1/2 dQ rounded to bf16 into the consumer's own Q tile
//   (swizzled) and out by TMA store, which drops rows past Sq.
// - setmaxnreg: producer 24 registers, consumers 240.
// - Shared memory: Q, dO 32 KB each + 4 stages x (K, V 16 KB each) =
//   192 KB, one CTA per SM.  The loop holds a stage until the next
//   tile's dQ product has read its K, so 2 stages leave no tile in
//   flight: 0.28 ms against 0.195 at the training shape.  128-key tiles
//   (S and dP as m64n128 products, 2 stages) spilled 144 bytes at 240
//   registers and took 0.300 ms against 0.192.  Measured on an H100 SXM
//   at 700 W with scripts/ab_flash_kernel.py.
//
// K4 design: flash_bwd_body.cuh's flash_bwd_kernel<kDq = false, 4>,
// the fused backward's (K2's) body with its dq share compiled out: 128
// keys per CTA, two 64-key consumer warpgroups holding dk and dv in
// registers, 64-row Q and dO tiles streamed by TMA through a 4-stage ring
// (0.6-1.4% faster than 2 stages in three A/B pairs; 3 stages no
// different), 4 wgmma products per tile pair (S^T, dP^T as SS; dV, dK as
// RS), dk and dv by TMA store.
//
// What held the previous (mma.sync) kernels back, and what this does
// about it: mma.sync with every fragment reloaded by ldmatrix from padded
// rows (now wgmma from swizzled tiles); 64-row CTAs of 4 warps, K3
// re-streaming K/V per 64 q rows (now 128) and K4 holding dk, dv, S^T and
// dP^T in 255 registers with a spill (now two 64-key warpgroups at 240
// registers); a synchronous cp.async double buffer with two __syncthreads
// per tile (now a TMA ring on mbarriers, loads overlapping both
// consumers' products); expf with its denormal path per score (now exp2
// with the scale folded into one FFMA).
//
// Tiles.  nos_flash_dq takes (block_q, block_k) = (q rows per CTA, keys
// per tile), nos_flash_dkv (q rows per tile, keys per CTA):
// - K3 (128, 64) = flash_dq_kernel<2, 4>, the default above;
// - K3 (64, 64) = flash_dq_kernel<1, 2>: one consumer owning 64 q rows,
//   Q, dO 16 KB each + 2 stages x (K, V 16 KB each) = 96 KB, two CTAs per
//   SM (setmaxnreg 24 / 232); with one stage in flight per CTA, the other
//   CTA on the SM covers the loads;
// - K4 (64, 128) = flash_bwd_kernel<false, 4, 2>, the default above;
// - K4 (64, 64) = flash_bwd_kernel<false, 2, 1>: one 64-key consumer,
//   K, V 16 KB each + 2 stages x (Q, dO 16 KB each + 512 B) = 97 KB, two
//   CTAs per SM.
// On an H100 SXM at 700 W (scripts/sweep_flash_torch.py, B8 H8) K3's
// (64, 64) lost at every length (2.4% at S512 causal to 20% at S4096
// full); K4's won from S512 to S4096 causal (12.5% at S512, 9% at S2048)
// and S512 to S2048 full, and lost by 0.6-3% at S4096 full and S8192.
// Any other tile returns cudaErrorInvalidValue.  Every variant keeps the
// fixed order of each output row's sums, so each repeats bitwise.
//
// ptxas (sm_90a): both default kernels 168 registers at entry (then 24 /
// 240 by setmaxnreg), no spill; chip_smoke.py's build phase reports every
// tile.

#include "flash_bwd_body.cuh"

namespace {

using namespace nos_hopper;

constexpr int kKeys = 64;                      // keys per K/V tile
constexpr uint32_t kTileBytes = 64 * kHeadDim * 2;   // 64 rows x 128, bf16
constexpr uint32_t kTileHalf = 64 * 128;             // bytes per half

// K4's Q/dO ring depth at the default tile: without the dq share K2's
// body has the shared memory for 4 stages (194 KB).
constexpr int kDkvStages = 4;

// K3's shared-memory layout: Q and dO (one 64-row tile per consumer), the
// K and V ring, the mbarriers.
template <int kConsumers, int kStages>
struct DqSmem {
  static constexpr int kRows = 64 * kConsumers;      // q rows per CTA
  static constexpr uint32_t kQOff = 0;
  static constexpr uint32_t kdOOff = kQOff + kConsumers * kTileBytes;
  static constexpr uint32_t kKOff = kdOOff + kConsumers * kTileBytes;
  static constexpr uint32_t kVOff = kKOff + kStages * kTileBytes;
  static constexpr uint32_t kBarOff = kVOff + kStages * kTileBytes;
  static constexpr int kNumBars = 1 + 2 * kStages;
  static constexpr int kBytes = kBarOff + kNumBars * 8 + 1024;  // + align
};

// P = exp(S D^-1/2 - lse) for one tile, in place, in the accumulator
// layout (rows row_a and row_a + 8 of this thread, 64 keys from key0),
// computed as exp2(s c - lse log2(e)) with c = D^-1/2 log2(e) (lse_c holds
// the two rows' lse log2(e)).  With kMasked, keys above the diagonal
// (causal) or past Sk, and rows past Sq, get p = 0.
template <bool kMasked>
__device__ __forceinline__ void p_tile(float (&s)[32],
                                       const float (&lse_c)[2], float c,
                                       int key0, int row_a, int t, int seq_q,
                                       int seq_k, int causal) {
#pragma unroll
  for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2_ftz(fmaf(s[4 * n + e], c, -lse_c[e >> 1]));
      if (kMasked) {
        const int key = key0 + 8 * n + 2 * t + (e & 1);
        const int row = row_a + (e >> 1) * 8;
        s[4 * n + e] =
            (key < seq_k && row < seq_q && !(causal && key > row)) ? p : 0.f;
      } else {
        s[4 * n + e] = p;
      }
    }
  }
}

template <int kConsumers, int kStages>
__global__ void __launch_bounds__(CtaShape<kConsumers>::kThreads,
                                  CtaShape<kConsumers>::kMinBlocks)
    flash_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const __grid_constant__ CUtensorMap dq_map,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, int heads, int seq_q,
                    int seq_k, float scale, int causal, int tiles_outer) {
  using L = DqSmem<kConsumers, kStages>;
  using Cta = CtaShape<kConsumers>;
  constexpr int kRows = L::kRows;
  constexpr uint32_t kQOff = L::kQOff, kdOOff = L::kdOOff, kKOff = L::kKOff,
                     kVOff = L::kVOff;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kStages;

  // Heaviest (last) q tiles first: of every (b, h) at once when the grid
  // is (H, B, tiles), within each (b, h) when it is (tiles, H, B).
  const int q_tile = tiles_outer ? gridDim.z - 1 - blockIdx.z
                                 : gridDim.x - 1 - blockIdx.x;
  const int h = tiles_outer ? blockIdx.x : blockIdx.y;
  const int b = tiles_outer ? blockIdx.y : blockIdx.z;
  const int m0 = q_tile * kRows;
  int n_tiles = (seq_k + kKeys - 1) / kKeys;
  if (causal) n_tiles = min(n_tiles, (m0 + kRows - 1) / kKeys + 1);

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // one arrive per warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer ----
    reg_dealloc<Cta::kProducerRegs>();
    if (tid == 0) {
      mbar_expect_tx(q_full, 2 * kConsumers * kTileBytes);
      for (int w = 0; w < kConsumers; ++w)
        for (int half = 0; half < 2; ++half) {
          tma_load_4d(smem + kQOff + w * kTileBytes + half * kTileHalf,
                      &q_map, q_full, half * kHalfCols, h, m0 + 64 * w, b);
          tma_load_4d(smem + kdOOff + w * kTileBytes + half * kTileHalf,
                      &do_map, q_full, half * kHalfCols, h, m0 + 64 * w, b);
        }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        if (j >= kStages) mbar_wait(&empty[st], ((j / kStages) - 1) & 1);
        mbar_expect_tx(&full[st], 2 * kTileBytes);
        for (int half = 0; half < 2; ++half) {
          tma_load_4d(smem + kKOff + st * kTileBytes + half * kTileHalf,
                      &k_map, &full[st], half * kHalfCols, h, j * kKeys, b);
          tma_load_4d(smem + kVOff + st * kTileBytes + half * kTileHalf,
                      &v_map, &full[st], half * kHalfCols, h, j * kKeys, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns q rows m0 + 64 wg .. + 63 ----
    reg_alloc<Cta::kConsumerRegs>();
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int row0 = m0 + 64 * wg;
    const int row_a = row0 + 16 * warp + g;  // and row_a + 8
    unsigned char* sq = smem + kQOff + wg * kTileBytes;
    const uint32_t q_addr = smem_u32(sq);
    const uint32_t do_addr = smem_u32(smem + kdOOff + wg * kTileBytes);
    // Under causal this warpgroup's last key is row0 + 63: the first
    // consumer needs one tile fewer than the second.  The tile it skips is
    // the last the producer loads, so no load waits for its release.
    const int my_tiles =
        causal ? min(n_tiles, (row0 + 63) / kKeys + 1) : n_tiles;

    // This thread's rows' statistics, fixed for the whole CTA.
    const int64_t stat0 = (static_cast<int64_t>(b) * heads + h) * seq_q;
    float lse_c[2], dlt[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row_a + 8 * i;
      lse_c[i] = r < seq_q ? lse[stat0 + r] * kLog2e : 0.f;
      dlt[i] = r < seq_q ? delta[stat0 + r] : 0.f;
    }
    const float c = scale * kLog2e;

    float dq[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dq[i] = 0.f;
    float s[32], dp[32];
    uint32_t da[kKeys / 16][4];

    // S_j = Q K_j^T and dP_j = dO V_j^T (64 rows x 64 keys each), one
    // commit group each.
    auto start_s_dp = [&](int j) {
      const int st = j % kStages;
      const uint32_t k_addr = smem_u32(smem + kKOff + st * kTileBytes);
      const uint32_t v_addr = smem_u32(smem + kVOff + st * kTileBytes);
      mbar_wait(&full[st], (j / kStages) & 1);
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk) {
        const uint32_t off = (kk / 4) * kTileHalf + (kk % 4) * 32;
        wgmma_m64n64_ss<0, 0>(s, smem_desc(q_addr + off, 0, 1024),
                              smem_desc(k_addr + off, 0, 1024), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk) {
        const uint32_t off = (kk / 4) * kTileHalf + (kk % 4) * 32;
        wgmma_m64n64_ss<0, 0>(dp, smem_desc(do_addr + off, 0, 1024),
                              smem_desc(v_addr + off, 0, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // dQ += dS_j K_j, dS from registers, K MN-major (16 keys per k-step).
    auto start_dq = [&](int j) {
      const uint32_t k_addr =
          smem_u32(smem + kKOff + (j % kStages) * kTileBytes);
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        wgmma_m64n128_rs<1>(dq, da[kk],
                            smem_desc(k_addr + kk * 16 * 128, kTileHalf, 1024),
                            1);
      wgmma_commit();
    };
    // P_j in s, in place; the mask only where a key can pass the diagonal
    // or a tile edge is ragged.
    auto p_of = [&](int j) {
      const int key0 = j * kKeys;
      if ((causal && key0 + kKeys - 1 > row0) || key0 + kKeys > seq_k ||
          row0 + 64 > seq_q)
        p_tile<true>(s, lse_c, c, key0, row_a, t, seq_q, seq_k, causal);
      else
        p_tile<false>(s, lse_c, c, key0, row_a, t, seq_q, seq_k, causal);
    };
    // dS_j = P_j (dP_j - delta) in dp, re-packed as bf16 A fragments.
    auto ds_of = [&]() {
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - dlt[(i >> 1) & 1]);
    };
    auto pack_ds = [&]() {
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) pack_a_frag(da[kk], dp, kk);
    };

    // Tile 0, then per tile j: S_j, dP_j and dQ += dS_{j-1} K_{j-1} go to
    // the tensor cores together; P_j is computed while dP_j and the dQ
    // product run, dS_j while the dQ product runs.
    mbar_wait(q_full, 0);
    wgmma_fence();
    start_s_dp(0);
    wgmma_wait<1>();
    fence_regs(s);
    p_of(0);
    wgmma_wait<0>();
    fence_regs(dp);
    ds_of();
    pack_ds();
    for (int j = 1; j < my_tiles; ++j) {
      fence_regs(dq);
      wgmma_fence();
      start_s_dp(j);
      start_dq(j - 1);
      wgmma_wait<2>();
      fence_regs(s);
      p_of(j);
      wgmma_wait<1>();
      fence_regs(dp);
      ds_of();
      wgmma_wait<0>();
      fence_regs(dq);
      if (lane == 0) mbar_arrive(&empty[(j - 1) % kStages]);  // K, V read
      pack_ds();
    }
    fence_regs(dq);
    wgmma_fence();
    start_dq(my_tiles - 1);
    wgmma_wait<0>();
    fence_regs(dq);

    // Epilogue: D^-1/2 dq into this consumer's own Q tile (its S products
    // are done), then out by TMA store, which drops rows past Sq.
    const int r = 16 * warp + g;
#pragma unroll
    for (int n = 0; n < kHeadDim / 8; ++n) {
      const int col = 8 * n + 2 * t;
      *reinterpret_cast<uint32_t*>(sq + swizzled_offset(r, col, kTileHalf)) =
          pack_bf16x2(dq[4 * n] * scale, dq[4 * n + 1] * scale);
      *reinterpret_cast<uint32_t*>(sq +
                                   swizzled_offset(r + 8, col, kTileHalf)) =
          pack_bf16x2(dq[4 * n + 2] * scale, dq[4 * n + 3] * scale);
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (tid == 0) {
      for (int half = 0; half < 2; ++half)
        tma_store_4d(&dq_map, sq + half * kTileHalf, half * kHalfCols, h,
                     row0, b);
      tma_store_commit_and_wait();
    }
  }
}

template <int kConsumers, int kStages>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int batch,
              int heads, int seq_q, int seq_k, int64_t q_sb, int64_t q_ss,
              int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
              int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb,
              int64_t o_ss, int64_t o_sh, float scale, int causal,
              void* stream) {
  using L = DqSmem<kConsumers, kStages>;
  const int64_t row = static_cast<int64_t>(heads) * kHeadDim;
  CUtensorMap q_map, k_map, v_map, do_map, dq_map;
  if (!make_bshd_map(&q_map, q, batch, seq_q, heads, q_sb, q_ss, q_sh, 64) ||
      !make_bshd_map(&k_map, k, batch, seq_k, heads, k_sb, k_ss, k_sh,
                     kKeys) ||
      !make_bshd_map(&v_map, v, batch, seq_k, heads, v_sb, v_ss, v_sh,
                     kKeys) ||
      !make_bshd_map(&do_map, dout, batch, seq_q, heads, o_sb, o_ss, o_sh,
                     64) ||
      !make_bshd_map(&dq_map, dq, batch, seq_q, heads, seq_q * row, row,
                     kHeadDim, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<kConsumers, kStages>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Launch order, K1's rule (flash_fwd.cu): when K and V fit in the L2
  // cache, every (b, h)'s heaviest q tiles go first; larger K/V keep each
  // (b, h)'s tiles together so their K/V stay in L2.
  int device = 0, l2_bytes = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&l2_bytes, cudaDevAttrL2CacheSize, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (seq_q + L::kRows - 1) / L::kRows;
  const double kv_bytes = 4.0 * batch * heads * seq_k * kHeadDim;
  const int tiles_outer = kv_bytes <= l2_bytes && tiles <= 65535;
  const dim3 grid = tiles_outer ? dim3(heads, batch, tiles)
                                : dim3(tiles, heads, batch);
  flash_dq_kernel<kConsumers, kStages>
      <<<grid, CtaShape<kConsumers>::kThreads, L::kBytes,
         static_cast<cudaStream_t>(stream)>>>(
          q_map, k_map, v_map, do_map, dq_map,
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          heads, seq_q, seq_k, scale, causal, tiles_outer);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Pointers are device pointers; q, k, v and dout are [B, S, H, D] with
// unit stride over D (D must be 128, strides multiples of 8 elements,
// 16-byte aligned starts), strides in elements.  lse and delta are
// contiguous fp32 [B, H, Sq]; dq is a contiguous bf16 [B, Sq, H, D].
// Causal requires seq_q == seq_k.  (block_q, block_k) picks the compiled
// tile, (128, 64) or (64, 64); any other returns cudaErrorInvalidValue, as
// does a refused tensor map; else cudaGetLastError() after the launch.
extern "C" int nos_flash_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int batch,
                            int heads, int seq_q, int seq_k, int64_t q_sb,
                            int64_t q_ss, int64_t q_sh, int64_t k_sb,
                            int64_t k_ss, int64_t k_sh, int64_t v_sb,
                            int64_t v_ss, int64_t v_sh, int64_t o_sb,
                            int64_t o_ss, int64_t o_sh, float scale,
                            int causal, int block_q, int block_k,
                            void* stream) {
  if (block_q == 128 && block_k == 64)
    return launch_dq<2, 4>(q, k, v, dout, lse, delta, dq, batch, heads,
                           seq_q, seq_k, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale, causal,
                           stream);
  if (block_q == 64 && block_k == 64)
    return launch_dq<1, 2>(q, k, v, dout, lse, delta, dq, batch, heads,
                           seq_q, seq_k, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale, causal,
                           stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As nos_flash_dq's arguments, with dk and dv contiguous bf16 [B, Sk, H, D]
// in place of dq; (block_q, block_k) is (64, 128) or (64, 64).
extern "C" int nos_flash_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv,
                             int batch, int heads, int seq_q, int seq_k,
                             int64_t q_sb, int64_t q_ss, int64_t q_sh,
                             int64_t k_sb, int64_t k_ss, int64_t k_sh,
                             int64_t v_sb, int64_t v_ss, int64_t v_sh,
                             int64_t o_sb, int64_t o_ss, int64_t o_sh,
                             float scale, int causal, int block_q,
                             int block_k, void* stream) {
  if (block_q == 64 && block_k == 128)
    return bwd::launch_flash_bwd<false, kDkvStages, 2>(
        q, k, v, dout, lse, delta, nullptr, dk, dv, batch, heads, seq_q,
        seq_k, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb,
        o_ss, o_sh, scale, causal, stream);
  if (block_q == 64 && block_k == 64)
    return bwd::launch_flash_bwd<false, 2, 1>(
        q, k, v, dout, lse, delta, nullptr, dk, dv, batch, heads, seq_q,
        seq_k, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb,
        o_ss, o_sh, scale, causal, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
