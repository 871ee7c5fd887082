// Fused flash-attention backward for Hopper (sm_90a): dq, dk and dv in one
// pass, 5 matrix products per (q tile, k tile) pair (K2).
//
// Replaces: the Pallas TPU kernel `_fused_bwd_kernel` in
// nos_tpu/ops/attention.py (launched by `_flash_backward_fused`).  The
// numerics are the TPU kernel's: s = (q . k^T, fp32) * D^-1/2 with an
// additive -1e30 causal mask; p = exp(s - lse) in fp32; dv += p^T . dO with
// p rounded to bf16; dp = dO . v^T; ds = p * (dp - delta) rounded to bf16;
// dk += ds^T . q, scaled by D^-1/2 at the end; dq = D^-1/2 * ds . k summed
// in fp32 over every key and rounded to bf16 once (by the wrapper).
//
// What bounds it on an H100 SXM: operations.  At the training shape (B 8,
// S 2048, H 8, D 128, causal, bf16) it does 1.72e11 FLOP = 0.174 ms at
// 989 TFLOP/s against ~236 MB of inputs and outputs (0.07 ms).  p, dp and
// ds never reach device memory.
//
// Design (warp-specialised, wgmma + TMA; hopper_common.cuh holds the
// machinery and its layout notes):
// - grid (ceil(Sk/128), H, B), 384 threads: two consumer warpgroups own 64
//   keys each and keep their dk and dv accumulators (64 x 128 fp32 each)
//   in registers for the whole run.  The producer warp loads the CTA's 128
//   K and V rows once, then streams 64-row Q and dO tiles by TMA into a
//   two-stage ring on full/empty mbarriers; its 32 lanes copy the tile's
//   lse (times log2 e) and delta rows beside them (a [B, H, S] row of any
//   length has no 16-byte aligned start for TMA).  The loop over q tiles
//   starts at the diagonal under causal; the first k tiles, which see the
//   most q tiles, are launched first.
// - Per q tile and consumer: S^T = K Q^T and dP^T = V dO^T are 8 SS wgmma
//   m64n64k16 each (K-major operands), started together; P^T = exp(S^T
//   D^-1/2 - lse) is one FFMA and one ex2.approx.ftz per entry (p_tile; the
//   mask is a second instance that only diagonal or ragged tiles run);
//   dS^T = P^T (dP^T - delta); both are re-packed as bf16 A fragments and
//   dV += P^T dO and dK += dS^T Q are 4 RS wgmma m64n128k16 each (dO and Q
//   MN-major).
// - dS^T (bf16) is written once to a 128B-swizzled [128 keys x 64 q] tile
//   while dV and dK run (double-buffered, so one named barrier per q tile
//   orders both consumers); dQ = dS K for the 64 q rows is then 8 SS wgmma m64n64k16
//   over the CTA's 128 keys, split by D: consumer w computes D columns
//   64w .. 64w + 63 (A = dS^T read MN-major, B = K MN-major).
// - D^-1/2 dQ goes through a double-buffered fp32 tile in shared memory
//   (two swizzled 64 x 32 boxes per consumer) into the wrapper's zeroed
//   fp32 [B, Sq, H, D] buffer by TMA reduce-add (cp.reduce.async.bulk
//   .tensor, one per box; rows past Sq are dropped by the map).  That is
//   half the element additions of the previous body's 64-key tiles, sent as
//   4 bulk operations per q tile and CTA instead of 16,384 scalar atomics.
//   The additions land in an order that varies from run to run, so K2 is
//   not guaranteed bitwise repeatable (the split pair in
//   flash_bwd_split.cu is).
// - setmaxnreg: producer 24 registers, consumers 240.
// - dk (times D^-1/2) and dv leave through the K and V tiles in shared
//   memory by TMA store, which drops rows past Sk.
// - Shared memory: K, V 32 KB each, 2 stages x (Q, dO 16 KB each + 512 B
//   of statistics), dS^T 2 x 16 KB, dQ 2 x 32 KB = 226 KB, one CTA per SM.
//
// What held the previous (mma.sync) body back, and what this does about it: mma.sync
// with every fragment reloaded by ldmatrix from padded rows (now wgmma
// from swizzled tiles); 4 warps owning 64 keys with dk, dv, S^T and dP^T
// live at once in 255 registers and a spill (now two 64-key warpgroups at
// 240 registers, no spill); 277 M scalar atomics after a __syncthreads and
// a dS^T round trip for every 64 keys (now one dS^T tile per 128 keys and
// TMA reductions); a synchronous cp.async double buffer with two
// __syncthreads per tile (now a TMA ring on mbarriers).
//
// ptxas (sm_90a, CUDA 12.9): 168 registers at entry (then 24 / 240 by
// setmaxnreg), no spill.

#include "hopper_common.cuh"

namespace {

using namespace nos_hopper;

constexpr int kBlockN = 128;                  // keys per CTA
constexpr int kBlockM = 64;                   // q rows per tile
constexpr int kStages = 2;
constexpr int kConsumers = 2;
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr uint32_t kKvBytes = kBlockN * kHeadDim * 2;
constexpr uint32_t kKvHalf = kBlockN * 128;
constexpr uint32_t kQBytes = kBlockM * kHeadDim * 2;
constexpr uint32_t kQHalf = kBlockM * 128;
constexpr uint32_t kDsBytes = kBlockN * kBlockM * 2;   // [key][q] bf16
constexpr uint32_t kStatBytes = kBlockM * 4;
constexpr uint32_t kKOff = 0;
constexpr uint32_t kVOff = kKOff + kKvBytes;
constexpr uint32_t kQOff = kVOff + kKvBytes;
constexpr uint32_t kdOOff = kQOff + kStages * kQBytes;
constexpr uint32_t kDsOff = kdOOff + kStages * kQBytes;
constexpr uint32_t kDqBytes = kBlockM * kHeadDim * 4;  // fp32 dQ tile
constexpr uint32_t kDqOff = kDsOff + 2 * kDsBytes;
constexpr uint32_t kLseOff = kDqOff + 2 * kDqBytes;
constexpr uint32_t kDeltaOff = kLseOff + kStages * kStatBytes;
constexpr uint32_t kBarOff = kDeltaOff + kStages * kStatBytes;
constexpr int kNumBars = 1 + 2 * kStages;
constexpr int kSmemBytes = kBarOff + kNumBars * 8 + 1024;   // + alignment
constexpr uint32_t kStageTx = 2 * kQBytes;   // TMA bytes per stage

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

__global__ void __launch_bounds__(kThreads, 1)
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
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kBarOff);
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
    reg_dealloc<24>();
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
          tma_load_4d(smem + kKOff + half * kKvHalf, &k_map, kv_full,
                      half * kHalfCols, h, key0, b);
          tma_load_4d(smem + kVOff + half * kKvHalf, &v_map, kv_full,
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
            tma_load_4d(smem + kQOff + st * kQBytes + half * kQHalf, &q_map,
                        &full[st], half * kHalfCols, h, i * kBlockM, b);
            tma_load_4d(smem + kdOOff + st * kQBytes + half * kQHalf,
                        &do_map, &full[st], half * kHalfCols, h, i * kBlockM,
                        b);
          }
        }
        float* lse_s = reinterpret_cast<float*>(smem + kLseOff +
                                                st * kStatBytes);
        float* delta_s = reinterpret_cast<float*>(smem + kDeltaOff +
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
    reg_alloc<240>();
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int key_a = key0 + 64 * wg + 16 * warp + g;  // and key_a + 8
    const uint32_t k_addr = smem_u32(smem + kKOff);
    const uint32_t v_addr = smem_u32(smem + kVOff);
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
      const uint32_t q_addr = smem_u32(smem + kQOff + st * kQBytes);
      const uint32_t do_addr = smem_u32(smem + kdOOff + st * kQBytes);
      unsigned char* ds = smem + kDsOff + (it & 1) * kDsBytes;
      const float* lse_s =
          reinterpret_cast<const float*>(smem + kLseOff + st * kStatBytes);
      const float* delta_s =
          reinterpret_cast<const float*>(smem + kDeltaOff + st * kStatBytes);

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
      // A warpgroup's products run in order, so waiting here costs the
      // tensor cores nothing and frees the P^T and dS^T fragments before
      // the dQ accumulator is live.
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      if (lane == 0) mbar_arrive(&empty[st]);  // Q, dO, stats are read

      // Both consumers' dS^T rows are in place: dQ = dS K for D columns
      // 64 wg .. 64 wg + 63 over the CTA's 128 keys.
      named_barrier(1, kConsumers * 128);
      float dq[32];
      const uint32_t ds_addr = smem_u32(ds);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
        wgmma_m64n64_ss<1, 1>(
            dq, smem_desc(ds_addr + kk * 16 * 128, 0, 1024),
            smem_desc(k_addr + wg * kKvHalf + kk * 16 * 128, 0, 1024),
            kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);

      // D^-1/2 * dQ into this WG's half of the fp32 tile buffer (two
      // swizzled boxes of 64 rows x 32 columns), then one TMA reduce-add
      // per box into dq_acc; rows past Sq are dropped by the map.  The
      // buffer is double-buffered: before writing it, the reduction
      // started two tiles ago must have read it.
      unsigned char* dqb = smem + kDqOff + (it & 1) * kDqBytes + wg * 16384;
      if (tid == 0) bulk_wait_read<1>();
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
            dqb + box + (r + 8) * 128 + ((((col >> 2) ^ ((r + 8) & 7))) << 4) +
            (col & 3) * 4) = make_float2(dq[4 * n + 2] * scale,
                                         dq[4 * n + 3] * scale);
      }
      fence_proxy_async();
      named_barrier(2 + wg, 128);
      if (tid == 0) {
        tma_reduce_add_4d(&dq_map, dqb, 64 * wg, h, q0, b);
        tma_reduce_add_4d(&dq_map, dqb + 8192, 64 * wg + 32, h, q0, b);
        bulk_commit();
      }
    }

    // Epilogue: both consumers are done reading K and V; dk = D^-1/2 * dk
    // and dv go through this WG's rows of the K and V tiles to TMA stores.
    named_barrier(1, kConsumers * 128);
    unsigned char* sk = smem + kKOff;
    unsigned char* sv = smem + kVOff;
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

}  // namespace

// Pointers are device pointers; q, k, v and dout are [B, S, H, D] with
// unit stride over D (D must be 128, strides multiples of 8 elements,
// 16-byte aligned starts), strides in elements.  lse and delta are
// contiguous fp32 [B, H, Sq]; dq_acc is a zeroed contiguous fp32
// [B, Sq, H, D]; dk and dv are contiguous bf16 [B, Sk, H, D].  Causal
// requires seq_q == seq_k.  Returns cudaErrorInvalidValue if a tensor map
// is refused, else cudaGetLastError() after the launch.
extern "C" int nos_flash_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq_acc, void* dk,
                             void* dv, int batch, int heads, int seq_q,
                             int seq_k, int64_t q_sb, int64_t q_ss,
                             int64_t q_sh, int64_t k_sb, int64_t k_ss,
                             int64_t k_sh, int64_t v_sb, int64_t v_ss,
                             int64_t v_sh, int64_t o_sb, int64_t o_ss,
                             int64_t o_sh, float scale, int causal,
                             void* stream) {
  const int64_t row = static_cast<int64_t>(heads) * kHeadDim;
  CUtensorMap q_map, k_map, v_map, do_map, dk_map, dv_map, dq_map;
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
      !make_bshd_map(&dq_map, dq_acc, batch, seq_q, heads, seq_q * row, row,
                     kHeadDim, kBlockM, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq_k + kBlockN - 1) / kBlockN, heads, batch);
  flash_bwd_kernel<<<grid, kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, do_map, dk_map, dv_map, dq_map,
      static_cast<const float*>(lse), static_cast<const float*>(delta), heads,
      seq_q, seq_k, scale, causal);
  return static_cast<int>(cudaGetLastError());
}
