// Split-schedule probe for Hopper (sm_90a): the production forward over one
// class of key tiles only.
//
// Replaces the TPU probe scripts/split_probe.py:one_pass, which launches
// K2's body (mmt_tpu/ops/pallas_attention.py:_fwd_list_kernel) once over
// the far list and once over the structured list of _split_tile_lists and
// times each.  The production forward (rel_attention_fwd.cu) computes the
// same function in one pass; this probe says what splitting it costs on the
// card.  Nothing on the retrieval or training paths calls it.
//
// Each pass is rel_attention_fwd.cuh's kernel cut by `SplitPass`: the same
// grid, ring, products, per-tile bias, masks and softmax, with each
// warpgroup computing only the key tiles of its class and the block's ring
// carrying the union of its warpgroups' tiles (split_class_tiles: the rule
// of _build_tile_meta at 64-blocks).  A tile (q0, k0) is FAR when both lie
// in the text part and every offset j - i in it is beyond the text distance
// on one side; its pairs share one id, so the kernel's uniform-tile path
// runs it.  Every other tile is STRUCTURED (the band, the image corner, the
// image x text parts): the uniform path for the image x text tiles, the
// per-pair ids for the rest.
//
// Each pass writes float32 partials: o [B, S, H, D] normalised by the
// pass's own row sum, lse [B, H, S]; a row with no live key of the class
// gets o = 0, lse = -inf (the kernel's empty-row rule), so that the
// caller's logsumexp combine (_forward_split, pallas_attention.py:
// 1585-1590) ignores it.  Key tiles with k0 >= L_b and query tiles with
// q0 >= L_b are skipped as in the production kernel.  No dropout, no window
// and no offsets: the split schedule is the dense retrieval path's.
//
// Bound (either pass): 4 * D * H FLOPs per real pair of its tiles plus the
// qr product, against the bytes of q, k, v read and o, lse written; at the
// retrieval shape the far pass is bound by operations, the structured pass
// by bytes.

#include "rel_attention_fwd.cuh"

// q, k, v: bf16 [B, S, H, 64] contiguous; rel: bf16 [H, 64, 64] contiguous
// (rows >= V zero) or null; lengths: int32 [B]; o: fp32 [B, S, H, 64];
// lse: fp32 [B, H, S].  far != 0 runs the far pass, else the structured
// pass.  Launches on `stream`, allocates nothing, returns the CUDA error
// code.
extern "C" int mmt_probe_split_pass(const void* q, const void* k, const void* v, const void* rel,
                                    const void* lengths, void* o, void* lse, int batch,
                                    int seq_len, int num_heads, int head_dim, int vocab,
                                    int image_len, int patch_per_row, int core_layers,
                                    int text_max_distance, int image_part_id, int text_part_id,
                                    float scale, int far, void* stream) {
  if (vocab < 0 || vocab > kVP || head_dim != 64 || seq_len <= 0 ||
      (rel != nullptr && image_len > 0 && patch_per_row > kMaxPatchPerRow))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.rel = static_cast<const __nv_bfloat16*>(rel);
  a.lengths = static_cast<const int*>(lengths);
  a.o_f32 = static_cast<float*>(o);
  a.lse = static_cast<float*>(lse);
  a.Sq = a.Sk = seq_len;
  a.H = num_heads;
  a.geo = Geometry{image_len,     patch_per_row, core_layers,     text_max_distance,
                   image_part_id, text_part_id,  rel ? vocab : 0, 0,
                   0};
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = far ? launch<64, false, false, SplitPass<kFarTiles>>(a, batch, s)
                              : launch<64, false, false, SplitPass<kStructuredTiles>>(a, batch, s);
  return static_cast<int>(err);
}

extern "C" const char* mmt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
