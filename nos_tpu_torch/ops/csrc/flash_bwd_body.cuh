// The body shared by the fused flash backward (K2, flash_bwd.cu) and the
// split backward's dk/dv kernel (K4, flash_bwd_split.cu), for Hopper
// (sm_90a): one CTA per 64 x kConsumers keys walks the q tiles and keeps dk
// and dv in registers.  Template arguments: kDq adds K2's dq share (the
// dS^T tile, the dQ product and the fp32 reduce-add); kStages is the depth
// of the Q/dO ring; kConsumers is the number of 64-key consumer
// warpgroups, 2 (128 keys per CTA, the default tile) or 1 (64 keys per
// CTA; hopper_common.cuh's CtaShape builds it for two CTAs an SM, which
// the shared memory allows without kDq).  Each source states its
// kernel's bound and design.
//
// The numerics are the TPU kernels': s = (q . k^T, fp32) * D^-1/2 with an
// additive -1e30 causal mask; p = exp(s - lse) in fp32; dv += p^T . dO with
// p rounded to bf16; dp = dO . v^T; ds = p * (dp - delta) rounded to bf16;
// dk += ds^T . q, scaled by D^-1/2 at the end; with kDq, dq = D^-1/2 *
// ds . k summed in fp32 over every key.
//
// Design (hopper_common.cuh holds the machinery and its layout notes):
// - grid (ceil(Sk/128), H, B), 384 threads: two consumer warpgroups own 64
//   keys each and keep their dk and dv accumulators (64 x 128 fp32 each)
//   in registers for the whole run.  The producer warp loads the CTA's 128
//   K and V rows once, then streams 64-row Q and dO tiles by TMA into a
//   kStages-deep ring on full/empty mbarriers; its 32 lanes copy the
//   tile's lse (times log2 e) and delta rows beside them (a [B, H, S] row
//   of any length has no 16-byte aligned start for TMA).  The loop over q
//   tiles starts at the diagonal under causal; the first k tiles, which
//   see the most q tiles, are launched first.
// - Per q tile and consumer: S^T = K Q^T and dP^T = V dO^T are 8 SS wgmma
//   m64n64k16 each (K-major operands), started together; P^T = exp(S^T
//   D^-1/2 - lse) is one FFMA and one ex2.approx.ftz per entry (p_tile; the
//   mask is a second instance that only diagonal or ragged tiles run);
//   dS^T = P^T (dP^T - delta); both are re-packed as bf16 A fragments and
//   dV += P^T dO and dK += dS^T Q are 4 RS wgmma m64n128k16 each (dO and Q
//   MN-major).
// - kDq: dS^T (bf16) is written once to a 128B-swizzled [128 keys x 64 q]
//   tile while dV and dK run (double-buffered, so one named barrier per q
//   tile orders both consumers); dQ = dS K for the 64 q rows is then 8 SS
//   wgmma m64n64k16 over the CTA's 128 keys, split by D: consumer w
//   computes D columns 64w .. 64w + 63 (A = dS^T read MN-major, B = K
//   MN-major).  D^-1/2 dQ goes through a double-buffered fp32 tile in
//   shared memory (two swizzled 64 x 32 boxes per consumer) into the
//   wrapper's zeroed fp32 [B, Sq, H, D] buffer by TMA reduce-add
//   (cp.reduce.async.bulk.tensor, one per box; rows past Sq are dropped by
//   the map).  The additions land in an order that varies from run to
//   run, so K2 is not guaranteed bitwise repeatable.  Without kDq nothing
//   crosses CTAs: every dk and dv row is written by one CTA after a loop
//   in a fixed order, so K4 is.
// - setmaxnreg: producer 24 registers, consumers 240 (232 with one
//   consumer; CtaShape).
// - dk (times D^-1/2) and dv leave through the K and V tiles in shared
//   memory by TMA store, which drops rows past Sk.
// - With one consumer (64 keys per CTA, 256 threads) the same body runs
//   over half the keys: grid (ceil(Sk/64), H, B), 64-key K/V boxes, a
//   [64 keys x 64 q] dS^T tile, and the one consumer computes both D
//   halves of dQ in turn, each reduced as soon as it is written.  Twice
//   the CTAs stream Q and dO, so twice the L2 reads of them.

#pragma once

#include "hopper_common.cuh"

namespace nos_hopper {
namespace bwd {
namespace {

constexpr int kBlockM = 64;                   // q rows per tile
constexpr uint32_t kQBytes = kBlockM * kHeadDim * 2;
constexpr uint32_t kQHalf = kBlockM * 128;
constexpr uint32_t kDqBytes = kBlockM * kHeadDim * 4;  // fp32 dQ tile
constexpr uint32_t kDqHalfBytes = kDqBytes / 2;        // 64 D columns
constexpr uint32_t kStatBytes = kBlockM * 4;
constexpr uint32_t kStageTx = 2 * kQBytes;   // TMA bytes per stage

// The tile's sizes and shared-memory layout: K, V, the Q and dO rings,
// with kDq the dS^T and dQ double buffers, the statistics' ring and the
// mbarriers.
template <bool kDq, int kStages, int kConsumers>
struct Smem {
  static constexpr int kBlockN = 64 * kConsumers;       // keys per CTA
  static constexpr uint32_t kKvBytes = kBlockN * kHeadDim * 2;
  static constexpr uint32_t kKvHalf = kBlockN * 128;
  static constexpr uint32_t kDsBytes = kBlockN * kBlockM * 2;  // [key][q]
  static constexpr uint32_t kKOff = 0;
  static constexpr uint32_t kVOff = kKOff + kKvBytes;
  static constexpr uint32_t kQOff = kVOff + kKvBytes;
  static constexpr uint32_t kdOOff = kQOff + kStages * kQBytes;
  static constexpr uint32_t kDsOff = kdOOff + kStages * kQBytes;
  static constexpr uint32_t kDqOff = kDsOff + (kDq ? 2 * kDsBytes : 0);
  static constexpr uint32_t kLseOff = kDqOff + (kDq ? 2 * kDqBytes : 0);
  static constexpr uint32_t kDeltaOff = kLseOff + kStages * kStatBytes;
  static constexpr uint32_t kBarOff = kDeltaOff + kStages * kStatBytes;
  static constexpr int kNumBars = 1 + 2 * kStages;
  static constexpr int kBytes = kBarOff + kNumBars * 8 + 1024;  // + align
};

// P^T = exp(S^T D^-1/2 - lse) for one tile, in place, in the accumulator
// layout (rows = 64 keys of this consumer, columns = 64 q rows), computed
// as exp2(s c - lse log2(e)) with c = D^-1/2 log2(e) (lse_c holds
// lse log2(e)).  With kMasked, entries above the diagonal (causal) or
// outside [0, Sk) x [0, Sq) are 0.
template <bool kMasked>
__device__ __forceinline__ void p_tile(float (&sT)[32], const float* lse_c,
                                       float c, int key_a, int q0, int t,
                                       int seq_q, int seq_k, int causal) {
#pragma unroll
  for (int n = 0; n < kBlockM / 8; ++n) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse_c + 8 * n + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2_ftz(fmaf(sT[4 * n + e], c, (e & 1) ? -l2.y : -l2.x));
      if (kMasked) {
        const int key = key_a + (e >> 1) * 8;
        const int q = q0 + 8 * n + 2 * t + (e & 1);
        sT[4 * n + e] =
            (key < seq_k && q < seq_q && !(causal && key > q)) ? p : 0.f;
      } else {
        sT[4 * n + e] = p;
      }
    }
  }
}

template <bool kDq, int kStages, int kConsumers>
__global__ void __launch_bounds__(CtaShape<kConsumers>::kThreads,
                                  CtaShape<kConsumers>::kMinBlocks)
    flash_bwd_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const __grid_constant__ CUtensorMap dk_map,
                     const __grid_constant__ CUtensorMap dv_map,
                     const __grid_constant__ CUtensorMap dq_map,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     int heads, int seq_q, int seq_k, float scale,
                     int causal) {
  using L = Smem<kDq, kStages, kConsumers>;
  using Cta = CtaShape<kConsumers>;
  constexpr int kBlockN = L::kBlockN;
  constexpr uint32_t kKvBytes = L::kKvBytes;
  constexpr uint32_t kKvHalf = L::kKvHalf;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kStages;

  const int key0 = blockIdx.x * kBlockN;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int i0 = causal ? key0 / kBlockM : 0;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA thread + the stats' lanes
      mbar_init(&empty[s], kConsumers * 4);  // one arrive per warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer ----
    reg_dealloc<Cta::kProducerRegs>();
    // One warp: lane 0 starts the TMA loads, and the 32 lanes copy the
    // tile's 64 lse and delta values (a [B, H, S] row of any length has
    // no 16-byte aligned rows for TMA), then arrive on the stage's full
    // barrier, whose arrive has release semantics.
    if (tid < 32) {
      const float* lse_bh = lse + (static_cast<int64_t>(b) * heads + h) * seq_q;
      const float* delta_bh =
          delta + (static_cast<int64_t>(b) * heads + h) * seq_q;
      if (tid == 0) {
        mbar_expect_tx(kv_full, 2 * kKvBytes);
        for (int half = 0; half < 2; ++half) {
          tma_load_4d(smem + L::kKOff + half * kKvHalf, &k_map, kv_full,
                      half * kHalfCols, h, key0, b);
          tma_load_4d(smem + L::kVOff + half * kKvHalf, &v_map, kv_full,
                      half * kHalfCols, h, key0, b);
        }
      }
      for (int i = i0; i * kBlockM < seq_q; ++i) {
        const int it = i - i0;
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(&empty[st], ((it / kStages) - 1) & 1);
        if (tid == 0) {
          mbar_expect_tx(&full[st], kStageTx);
          for (int half = 0; half < 2; ++half) {
            tma_load_4d(smem + L::kQOff + st * kQBytes + half * kQHalf,
                        &q_map, &full[st], half * kHalfCols, h, i * kBlockM,
                        b);
            tma_load_4d(smem + L::kdOOff + st * kQBytes + half * kQHalf,
                        &do_map, &full[st], half * kHalfCols, h, i * kBlockM,
                        b);
          }
        }
        float* lse_s = reinterpret_cast<float*>(smem + L::kLseOff +
                                                st * kStatBytes);
        float* delta_s = reinterpret_cast<float*>(smem + L::kDeltaOff +
                                                  st * kStatBytes);
#pragma unroll
        for (int r = tid; r < kBlockM; r += 32) {
          const int q = i * kBlockM + r;
          lse_s[r] = q < seq_q ? lse_bh[q] * kLog2e : 0.f;
          delta_s[r] = q < seq_q ? delta_bh[q] : 0.f;
        }
        mbar_arrive(&full[st]);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns keys key0 + 64 wg .. + 63 ----
    reg_alloc<Cta::kConsumerRegs>();
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int key_a = key0 + 64 * wg + 16 * warp + g;  // and key_a + 8
    const uint32_t k_addr = smem_u32(smem + L::kKOff);
    const uint32_t v_addr = smem_u32(smem + L::kVOff);
    const uint32_t ka_addr = k_addr + 64 * wg * 128;   // this WG's rows
    const uint32_t va_addr = v_addr + 64 * wg * 128;

    const float c = scale * kLog2e;
    float dk[64], dv[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int i = i0; i * kBlockM < seq_q; ++i) {
      const int it = i - i0;
      const int st = it % kStages;
      const int q0 = i * kBlockM;
      const uint32_t q_addr = smem_u32(smem + L::kQOff + st * kQBytes);
      const uint32_t do_addr = smem_u32(smem + L::kdOOff + st * kQBytes);
      const float* lse_s =
          reinterpret_cast<const float*>(smem + L::kLseOff + st * kStatBytes);
      const float* delta_s = reinterpret_cast<const float*>(
          smem + L::kDeltaOff + st * kStatBytes);

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 q rows each.
      float sT[32], dpT[32];
      mbar_wait(&full[st], (it / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_m64n64_ss<0, 0>(
            sT, smem_desc(ka_addr + (kk / 4) * kKvHalf + off, 0, 1024),
            smem_desc(q_addr + (kk / 4) * kQHalf + off, 0, 1024), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_m64n64_ss<0, 0>(
            dpT, smem_desc(va_addr + (kk / 4) * kKvHalf + off, 0, 1024),
            smem_desc(do_addr + (kk / 4) * kQHalf + off, 0, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sT);

      // P^T = exp(scale * S^T + mask - lse), 0 outside [0, Sk) x [0, Sq).
      if ((causal && q0 < key0 + kBlockN) || q0 + kBlockM > seq_q ||
          key0 + kBlockN > seq_k)
        p_tile<true>(sT, lse_s, c, key_a, q0, t, seq_q, seq_k, causal);
      else
        p_tile<false>(sT, lse_s, c, key_a, q0, t, seq_q, seq_k, causal);
      wgmma_wait<0>();
      fence_regs(dpT);
      // dS^T = P^T (dP^T - delta), kept in dpT.
#pragma unroll
      for (int n = 0; n < kBlockM / 8; ++n) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(delta_s + 8 * n + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpT[4 * n + e] =
              sT[4 * n + e] * (dpT[4 * n + e] - ((e & 1) ? d2.y : d2.x));
      }
      uint32_t pa[kBlockM / 16][4], da[kBlockM / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBlockM / 16; ++kk) {
        pack_a_frag(pa[kk], sT, kk);
        pack_a_frag(da[kk], dpT, kk);
      }
      // dV += P^T dO and dK += dS^T Q (16 q rows per k-step), started
      // before the dS^T stores below so that those overlap the products.
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockM / 16; ++kk)
        wgmma_m64n128_rs<1>(dv, pa[kk],
                            smem_desc(do_addr + kk * 16 * 128, kQHalf, 1024),
                            1);
#pragma unroll
      for (int kk = 0; kk < kBlockM / 16; ++kk)
        wgmma_m64n128_rs<1>(dk, da[kk],
                            smem_desc(q_addr + kk * 16 * 128, kQHalf, 1024),
                            1);
      wgmma_commit();

      [[maybe_unused]] unsigned char* ds =
          smem + L::kDsOff + (it & 1) * L::kDsBytes;
      if constexpr (kDq) {
        // dS^T (bf16, the values of da) into this WG's rows of the shared
        // [key][q] tile for the dQ product.
        const int r = 64 * wg + 16 * warp + g;
#pragma unroll
        for (int n = 0; n < kBlockM / 8; ++n) {
          const int c = 8 * n + 2 * t;
          *reinterpret_cast<uint32_t*>(ds + swizzled_offset(r, c, 0)) =
              da[n / 2][(n & 1) * 2];
          *reinterpret_cast<uint32_t*>(ds + swizzled_offset(r + 8, c, 0)) =
              da[n / 2][(n & 1) * 2 + 1];
        }
        fence_proxy_async();
      }
      // A warpgroup's products run in order, so waiting here costs the
      // tensor cores nothing and frees the P^T and dS^T fragments before
      // the dQ accumulator is live.
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      if (lane == 0) mbar_arrive(&empty[st]);  // Q, dO, stats are read

      if constexpr (kDq) {
        // Every consumer's dS^T rows are in place: dQ = dS K over the
        // CTA's keys, 64 D columns (one half) at a time; consumer wg takes
        // the 2 / kConsumers halves from wg * 2 / kConsumers.
        named_barrier(1, kConsumers * 128);
        const uint32_t ds_addr = smem_u32(ds);
        unsigned char* dq_tile = smem + L::kDqOff + (it & 1) * kDqBytes;
        constexpr int kHalves = 2 / kConsumers;
#pragma unroll
        for (int j = 0; j < kHalves; ++j) {
          const int dh = wg * kHalves + j;
          float dq[32];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBlockN / 16; ++kk)
            wgmma_m64n64_ss<1, 1>(
                dq, smem_desc(ds_addr + kk * 16 * 128, 0, 1024),
                smem_desc(k_addr + dh * kKvHalf + kk * 16 * 128, 0, 1024),
                kk > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dq);

          // D^-1/2 * dQ into this half of the fp32 tile buffer (two
          // swizzled boxes of 64 rows x 32 columns), then one TMA
          // reduce-add per box into dq_acc; rows past Sq are dropped by
          // the map.  The buffer is double-buffered by q tile: before
          // writing a half, the reduction that read it two tiles ago must
          // be done, behind the kHalves - 1 halves of that tile and the
          // kHalves of the last that this thread committed since.
          unsigned char* dqb = dq_tile + dh * kDqHalfBytes;
          if (tid == 0) bulk_wait_read<2 * kHalves - 1>();
          named_barrier(2 + wg, 128);
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const int col = (8 * n + 2 * t) & 31;
            const int r = 16 * warp + g;
            const uint32_t box = (n >> 2) * 8192;
            *reinterpret_cast<float2*>(
                dqb + box + r * 128 + ((((col >> 2) ^ (r & 7))) << 4) +
                (col & 3) * 4) = make_float2(dq[4 * n] * scale,
                                             dq[4 * n + 1] * scale);
            *reinterpret_cast<float2*>(
                dqb + box + (r + 8) * 128 +
                ((((col >> 2) ^ ((r + 8) & 7))) << 4) + (col & 3) * 4) =
                make_float2(dq[4 * n + 2] * scale, dq[4 * n + 3] * scale);
          }
          fence_proxy_async();
          named_barrier(2 + wg, 128);
          if (tid == 0) {
            tma_reduce_add_4d(&dq_map, dqb, 64 * dh, h, q0, b);
            tma_reduce_add_4d(&dq_map, dqb + 8192, 64 * dh + 32, h, q0, b);
            bulk_commit();
          }
        }
      }
    }

    // Epilogue: both consumers are done reading K and V; dk = D^-1/2 * dk
    // and dv go through this WG's rows of the K and V tiles to TMA stores.
    named_barrier(1, kConsumers * 128);
    unsigned char* sk = smem + L::kKOff;
    unsigned char* sv = smem + L::kVOff;
    const int r = 64 * wg + 16 * warp + g;
#pragma unroll
    for (int n = 0; n < kHeadDim / 8; ++n) {
      const int c = 8 * n + 2 * t;
      *reinterpret_cast<uint32_t*>(sk + swizzled_offset(r, c, kKvHalf)) =
          pack_bf16x2(dk[4 * n] * scale, dk[4 * n + 1] * scale);
      *reinterpret_cast<uint32_t*>(sk + swizzled_offset(r + 8, c, kKvHalf)) =
          pack_bf16x2(dk[4 * n + 2] * scale, dk[4 * n + 3] * scale);
      *reinterpret_cast<uint32_t*>(sv + swizzled_offset(r, c, kKvHalf)) =
          pack_bf16x2(dv[4 * n], dv[4 * n + 1]);
      *reinterpret_cast<uint32_t*>(sv + swizzled_offset(r + 8, c, kKvHalf)) =
          pack_bf16x2(dv[4 * n + 2], dv[4 * n + 3]);
    }
    fence_proxy_async();
    named_barrier(2 + wg, 128);
    if (tid == 0) {
      for (int half = 0; half < 2; ++half) {
        const uint32_t off = half * kKvHalf + 64 * wg * 128;
        tma_store_4d(&dk_map, sk + off, half * kHalfCols, h, key0 + 64 * wg,
                     b);
        tma_store_4d(&dv_map, sv + off, half * kHalfCols, h, key0 + 64 * wg,
                     b);
      }
      tma_store_commit_and_wait();
    }
  }
}

// Encodes the maps and launches flash_bwd_kernel<kDq, kStages,
// kConsumers> on `stream`.  Pointers are device pointers; q, k, v and
// dout are [B, S, H, D] with unit stride over D (D must be 128, strides
// multiples of 8 elements, 16-byte aligned starts), strides in elements.
// lse and
// delta are contiguous fp32 [B, H, Sq]; dk and dv are contiguous bf16
// [B, Sk, H, D]; with kDq, dq_acc is a zeroed contiguous fp32
// [B, Sq, H, D] (without, it is not read).  Causal requires
// seq_q == seq_k.  Returns cudaErrorInvalidValue if a tensor map is
// refused, else cudaGetLastError() after the launch.
template <bool kDq, int kStages, int kConsumers>
inline int launch_flash_bwd(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq_acc, void* dk,
                            void* dv, int batch, int heads, int seq_q,
                            int seq_k, int64_t q_sb, int64_t q_ss,
                            int64_t q_sh, int64_t k_sb, int64_t k_ss,
                            int64_t k_sh, int64_t v_sb, int64_t v_ss,
                            int64_t v_sh, int64_t o_sb, int64_t o_ss,
                            int64_t o_sh, float scale, int causal,
                            void* stream) {
  using L = Smem<kDq, kStages, kConsumers>;
  constexpr int kBlockN = L::kBlockN;
  const int64_t row = static_cast<int64_t>(heads) * kHeadDim;
  CUtensorMap q_map, k_map, v_map, do_map, dk_map, dv_map, dq_map = {};
  if (!make_bshd_map(&q_map, q, batch, seq_q, heads, q_sb, q_ss, q_sh,
                     kBlockM) ||
      !make_bshd_map(&k_map, k, batch, seq_k, heads, k_sb, k_ss, k_sh,
                     kBlockN) ||
      !make_bshd_map(&v_map, v, batch, seq_k, heads, v_sb, v_ss, v_sh,
                     kBlockN) ||
      !make_bshd_map(&do_map, dout, batch, seq_q, heads, o_sb, o_ss, o_sh,
                     kBlockM) ||
      !make_bshd_map(&dk_map, dk, batch, seq_k, heads, seq_k * row, row,
                     kHeadDim, 64) ||
      !make_bshd_map(&dv_map, dv, batch, seq_k, heads, seq_k * row, row,
                     kHeadDim, 64) ||
      (kDq && !make_bshd_map(&dq_map, dq_acc, batch, seq_q, heads,
                             seq_q * row, row, kHeadDim, kBlockM, 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<kDq, kStages, kConsumers>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq_k + kBlockN - 1) / kBlockN, heads, batch);
  flash_bwd_kernel<kDq, kStages, kConsumers>
      <<<grid, CtaShape<kConsumers>::kThreads, L::kBytes,
         static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, do_map, dk_map, dv_map, dq_map,
      static_cast<const float*>(lse), static_cast<const float*>(delta), heads,
      seq_q, seq_k, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace bwd
}  // namespace nos_hopper
