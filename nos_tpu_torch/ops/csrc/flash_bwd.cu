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
// Design (warp-specialised, wgmma + TMA): flash_bwd_kernel<kDq = true,
// kStages = 2, kConsumers = 2> of flash_bwd_body.cuh, whose notes hold the
// design:
// 128 keys per CTA, two 64-key consumer warpgroups holding dk and dv in
// registers, 64-row Q and dO tiles streamed by TMA, five wgmma products
// per tile pair, dq added into the wrapper's zeroed fp32 buffer by TMA
// reduce-add (4 bulk operations per q tile and CTA instead of 16,384
// scalar atomics).  The additions land in an order that varies from run
// to run, so K2 is not guaranteed bitwise repeatable (the split pair in
// flash_bwd_split.cu is).  Shared memory: K, V 32 KB each, 2 stages x
// (Q, dO 16 KB each + 512 B of statistics), dS^T 2 x 16 KB, dQ 2 x 32 KB
// = 226 KB, one CTA per SM.
//
// What held the previous (mma.sync) body back, and what this does about
// it: mma.sync with every fragment reloaded by ldmatrix from padded rows
// (now wgmma from swizzled tiles); 4 warps owning 64 keys with dk, dv,
// S^T and dP^T live at once in 255 registers and a spill (now two 64-key
// warpgroups at 240 registers, no spill); 277 M scalar atomics after a
// __syncthreads and a dS^T round trip for every 64 keys (now one dS^T
// tile per 128 keys and TMA reductions); a synchronous cp.async double
// buffer with two __syncthreads per tile (now a TMA ring on mbarriers).
//
// Tiles.  nos_flash_bwd takes (block_q, block_k) = (q rows per tile,
// keys per CTA):
// - (64, 128) = flash_bwd_kernel<true, 2, 2>, the default above.
// - (64, 64) = flash_bwd_kernel<true, 2, 1>: one 64-key consumer per CTA,
//   K, V 16 KB each, 2 stages x (Q, dO 16 KB each + 512 B), dS^T 2 x 8
//   KB, dQ 2 x 32 KB = 177 KB: still one CTA per SM (the dQ buffers do
//   not shrink with the keys), so a CTA holds one consumer where the
//   default holds two.  On an H100 SXM at 700 W
//   (scripts/sweep_flash_torch.py, B8 H8) it lost at every length, by 8%
//   at S512 causal up to 47% at S4096 full.
// Any other tile returns cudaErrorInvalidValue.
//
// ptxas (sm_90a, CUDA 12.9): 168 registers at entry for (64, 128) (then
// 24 / 240 by setmaxnreg), no spill; chip_smoke.py's build phase reports
// both tiles.

#include "flash_bwd_body.cuh"

// See launch_flash_bwd (flash_bwd_body.cuh) for the arguments; dq_acc is
// a zeroed contiguous fp32 [B, Sq, H, D].  (block_q, block_k) picks the
// compiled tile, (64, 128) or (64, 64); any other returns
// cudaErrorInvalidValue.
extern "C" int nos_flash_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq_acc, void* dk,
                             void* dv, int batch, int heads, int seq_q,
                             int seq_k, int64_t q_sb, int64_t q_ss,
                             int64_t q_sh, int64_t k_sb, int64_t k_ss,
                             int64_t k_sh, int64_t v_sb, int64_t v_ss,
                             int64_t v_sh, int64_t o_sb, int64_t o_ss,
                             int64_t o_sh, float scale, int causal,
                             int block_q, int block_k, void* stream) {
  using nos_hopper::bwd::launch_flash_bwd;
  if (block_q == 64 && block_k == 128)
    return launch_flash_bwd<true, 2, 2>(
        q, k, v, dout, lse, delta, dq_acc, dk, dv, batch, heads, seq_q,
        seq_k, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb,
        o_ss, o_sh, scale, causal, stream);
  if (block_q == 64 && block_k == 64)
    return launch_flash_bwd<true, 2, 1>(
        q, k, v, dout, lse, delta, dq_acc, dk, dv, batch, heads, seq_q,
        seq_k, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb,
        o_ss, o_sh, scale, causal, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
