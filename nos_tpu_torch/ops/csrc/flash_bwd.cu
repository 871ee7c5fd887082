// Fused flash-attention backward for Hopper (sm_90a): dq, dk and dv in one
// pass, 5 matrix products per (q tile, k tile) pair.
//
// Replaces: the Pallas TPU kernel `_fused_bwd_kernel` in
// nos_tpu/ops/attention.py (launched by `_flash_backward_fused`).  The
// body is flash_bwd_kv_kernel<true> in flash_bwd_kv.cuh; its header says
// how the work is laid out.
//
// What bounds it: operations.  At the training shape (B 8, S 2048, H 8,
// D 128, causal, bf16) it does 1.72e11 FLOP against ~236 MB of inputs and
// outputs, so the tensor cores and not the memory are the limit.  The
// design keeps p, dp and ds in registers and shared memory (they never
// reach device memory) and reads each K/V tile once per CTA.
//
// dq across k tiles: the TPU kernel writes one bf16 dq partial per k block
// and sums them outside, because a TPU has no atomics.  Here every CTA
// adds its D^-1/2 * ds . k rows into one zeroed fp32 [B, Sq, H, D] buffer
// with atomicAdd, and the wrapper rounds that buffer to bf16.  The sum is
// exact to fp32 rounding but its order, and so its last bits, vary from
// run to run; the deterministic split kernels (flash_bwd_split.cu) are
// the alternative.

#include "flash_bwd_kv.cuh"

// Pointers are device pointers; q, k, v and dout are [B, S, H, D] with
// unit stride over D (D must be 128, rows 16-byte aligned), strides in
// elements.  lse and delta are contiguous fp32 [B, H, Sq]; dq_acc is a
// zeroed contiguous fp32 [B, Sq, H, D]; dk and dv are contiguous bf16
// [B, Sk, H, D].  Causal requires seq_q == seq_k.  Returns
// cudaGetLastError() after the launch.
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
  return nos_flash::launch_bwd_kv<true>(
      q, k, v, dout, lse, delta, dq_acc, dk, dv, batch, heads, seq_q, seq_k,
      q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
      scale, causal, stream);
}
