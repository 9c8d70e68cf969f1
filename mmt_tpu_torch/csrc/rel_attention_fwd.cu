// Relative-bias flash attention forward for Hopper (sm_90a): the
// production entry point.
//
// Replaces the two TPU forward kernels of mmt_tpu/ops/pallas_attention.py:
//   K1 `_fwd_kernel` (rect grid, `_attention_forward`) and
//   K2 `_fwd_list_kernel` (list grid, `_run_fwd_list`), in both of its
//   uses: the far/structured split schedule `_forward_split` (with the
//   image-corner build `_build_img_corner` and the logsumexp combine of the
//   split) and the sliding-window live-tile list `_window_tile_list`
//   (`_attention_forward` :1891-1919).  Both lists are TPU schedules, not
//   semantics: one pass here computes the function they compute, and the
//   split's far/structured distinction becomes a per-tile branch.
//
// The kernel, what it computes, what bounds it and its design are in
// rel_attention_fwd.cuh, which the probes (probe_split.cu,
// probe_op_cost.cu) instantiate too; this file launches it whole (`Whole`):
// every live tile and every op family, bf16 o and lse.

#include "rel_attention_fwd.cuh"

namespace {

using LaunchFn = decltype(&launch<64, false, false>);

template <int D>
LaunchFn pick(bool drop, bool window) {
  if (drop) return window ? launch<D, true, true> : launch<D, true, false>;
  return window ? launch<D, false, true> : launch<D, false, false>;
}

}  // namespace

// q, o: bf16 [B, S_q, H, D], k, v: bf16 [B, S_k, H, D], contiguous; rel:
// bf16 [H, 64, D] contiguous (rows >= V zero) or null; lengths: int32 [B]
// (global); lse: fp32 [B, H, S_q].  q_start, k_start: the global positions
// of q's row 0 and k's key 0, multiples of 64 (0 without sharding).
// dropout_threshold = round(rate * 2^24) (0: no dropout), keep_scale =
// float32(1 / (1 - rate)), seed: the call's int32 seed, batch_start: global
// index of example 0.  window > 0 selects the sliding-window pattern with
// the global prefix [0, num_global) (num_global > 0; ignored at window 0).
// With the 2D ids, patch_per_row <= 32 (the image id table).
// Launches on `stream`, allocates nothing, returns the CUDA error code.
extern "C" int mmt_rel_attention_fwd(const void* q, const void* k, const void* v, const void* rel,
                                     const void* lengths, void* o, void* lse, int batch,
                                     int seq_q, int seq_k, int q_start, int k_start,
                                     int num_heads, int head_dim, int vocab,
                                     int image_len, int patch_per_row, int core_layers,
                                     int text_max_distance, int image_part_id, int text_part_id,
                                     int window, int num_global, float scale,
                                     int dropout_threshold, float keep_scale, int seed,
                                     int batch_start, void* stream) {
  if (vocab < 0 || vocab > kVP || dropout_threshold < 0 || dropout_threshold > (1 << 24) ||
      window < 0 || (window > 0 && num_global <= 0) || q_start < 0 || k_start < 0 ||
      q_start % kT || k_start % kT || seq_q <= 0 || seq_k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rel != nullptr && image_len > 0 && patch_per_row > kMaxPatchPerRow)
    return static_cast<int>(cudaErrorInvalidValue);
  // The same pattern; keeps r0 + w from overflowing.
  window = min(window, max(q_start + seq_q, k_start + seq_k));
  FwdArgs a{};  // the probes' outputs stay null
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.rel = static_cast<const __nv_bfloat16*>(rel);
  a.lengths = static_cast<const int*>(lengths);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.lse = static_cast<float*>(lse);
  a.Sq = seq_q;
  a.Sk = seq_k;
  a.q_start = q_start;
  a.k_start = k_start;
  a.H = num_heads;
  a.geo = Geometry{image_len,     patch_per_row, core_layers,     text_max_distance,
                   image_part_id, text_part_id,  rel ? vocab : 0, window,
                   num_global};
  a.scale = scale;
  a.dr = Dropout{static_cast<uint32_t>(dropout_threshold), keep_scale,
                 static_cast<uint32_t>(seed), static_cast<uint32_t>(batch_start)};
  const bool drop = dropout_threshold > 0;
  LaunchFn fn;
  if (head_dim == 64) {
    fn = pick<64>(drop, window > 0);
  } else if (head_dim == 32) {
    fn = pick<32>(drop, window > 0);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(fn(a, batch, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* mmt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
