// Op-cost probe for Hopper (sm_90a): what each op family of the
// relative-attention forward costs inside that kernel.
//
// Replaces the TPU probe scripts/op_cost_probe.py (make / bench): the
// flagship kernel's grid, a common baseline, one op family added per
// variant; a variant's time minus the baseline's is that family's cost over
// the grid.  Nothing on the retrieval or training paths calls it.
//
// Every variant is rel_attention_fwd.cuh's kernel cut by `OpCost`: the
// production forward's grid (128-row blocks of two warpgroups), its set-up
// (Q and R_h by cp.async, qr = Q . R_h^T by wgmma, the image id tables),
// its K / V TMA ring and S = Q . K^T by wgmma over the dense walk's live
// tiles, with the op families of the variant switched on at compile time,
// so each family runs the production kernel's own lines.  Every variant
// writes one float per row,
//
//   out[b, h, i] = sum_{j < 64 * ceil(L_b / 64)} x(i, j) + qr2[i, 0] (+ extra)
//
// for the rows of the query tiles below the length (0 past them), so that
// nothing it computes is dead code.  x(i, j) is the kernel's base-2 logit
// as far as the variant computes it, x = acc(i, j) * c2 with acc = q_i . k_j
// and c2 = scale * log2(e), and qr2 = c2 * q . R^T as the kernel keeps it.
// Variants (VARIANTS in probes/op_cost_probe.py, in this order):
//
//   base       x = acc * c2
//   ids        x += id(i, j), the production's id forms (one id per uniform
//              tile, the image table, the clipped band offset, the per-pair
//              choice on the edge tiles), clamped to 64
//   gather     x += qr2[i, id(i, j)] (id < V): the production's bias; its
//              own cost is gather - ids
//   rank1      x += qr2[i, id_tile] on every tile, the far-tile form (id D
//              right of the diagonal tile, 2D on and left of it)
//   mask       x += -10000 log2(e) where (i < L) != (j < L), on the tiles
//              that hold the length
//   window     x += -10000 log2(e) where the pattern disallows (i, j), on
//              the tiles the band edge cuts (the walk stays dense)
//   hash       x *= the dropout keep factor at rate 0.1 (hash_row hoisted)
//   exp        x = exp2(x)
//   reduce     out = lse_i + qr2[i, 0]: exp with the online softmax's row
//              max, row sum and rescale; its own cost is reduce - exp
//   pv         extra = sum_d (bf16(x) . V)[i, d]: P from registers, V
//              read MN-major, wgmma
//   atomics    the baseline plus 49 x 64 fp32 global atomics per block
//              (rows 0..48 of the block's Q tile into out2[b, h, :49, :]),
//              the backward's dRel epilogue pattern
//   full       every family of the forward at rate 0: out = lse_i + sum_d
//              o[i, d] on rows below the length (0 past it)
//   full_hash  the same at rate 0.1
//   one_warpgroup  the baseline with one 64-row warpgroup per block (3
//              blocks per SM): the baseline's numbers
//   sync_loads the baseline with each K / V tile copied by cp.async behind
//              block barriers instead of the TMA ring: the baseline's numbers
//
// Bound: the families' products (2 * 64 * 64 * D FLOPs per visited tile for
// Q . K^T, as many again for P . V) and the qr product, against the bytes of
// q, k (and v) read once; the probe reports times beside the production
// kernel's.

#include "rel_attention_fwd.cuh"

namespace {

using LaunchFn = cudaError_t (*)(const FwdArgs&, int, cudaStream_t);

constexpr LaunchFn kVariants[] = {
    launch<64, false, false, OpCost<0>>,
    launch<64, false, false, OpCost<kOpIds>>,
    launch<64, false, false, OpCost<kOpIds | kOpGather>>,
    launch<64, false, false, OpCost<kOpRank1 | kOpGather>>,
    launch<64, false, false, OpCost<kOpMask>>,
    launch<64, false, true, OpCost<kOpWindow>>,
    launch<64, true, false, OpCost<kOpHash>>,
    launch<64, false, false, OpCost<kOpExp>>,
    launch<64, false, false, OpCost<kOpExp | kOpReduce>>,
    launch<64, false, false, OpCost<kOpPv>>,
    launch<64, false, false, OpCost<kOpAtomics>>,
    launch<64, false, false, OpCost<kForwardOps>>,
    launch<64, true, false, OpCost<kForwardOps>>,
    launch<64, false, false, OpCost<0, 1>>,
    launch<64, false, false, OpCost<0, 2, false>>,
};
constexpr int kNumVariants = sizeof(kVariants) / sizeof(kVariants[0]);

}  // namespace

// q, k, v: bf16 [B, S, H, 64] contiguous, S a multiple of 64; rel: bf16
// [H, 64, 64] contiguous (rows >= V zero); lengths: int32 [B]; out: fp32
// [B, H, S]; out2: fp32 [B, H, 64, 64], zeroed by the caller (written by
// the atomics variant only).  `variant` indexes kVariants above.  window /
// num_global are read by the window variant, the dropout arguments by the
// hash and full_hash variants.  Launches on `stream`, allocates nothing,
// returns the CUDA error code.
extern "C" int mmt_probe_op_cost(const void* q, const void* k, const void* v, const void* rel,
                                 const void* lengths, void* out, void* out2, int variant,
                                 int batch, int seq_len, int num_heads, int head_dim, int vocab,
                                 int image_len, int patch_per_row, int core_layers,
                                 int text_max_distance, int image_part_id, int text_part_id,
                                 int window, int num_global, float scale, int dropout_threshold,
                                 float keep_scale, int seed, void* stream) {
  if (variant < 0 || variant >= kNumVariants || head_dim != 64 || seq_len <= 0 ||
      seq_len % kT != 0 || vocab < 1 || vocab > kVP || rel == nullptr ||
      2 * text_max_distance >= vocab || window < 0 || num_global < 0 ||
      dropout_threshold < 0 || dropout_threshold > (1 << 24) ||
      (image_len > 0 && patch_per_row > kMaxPatchPerRow))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.rel = static_cast<const __nv_bfloat16*>(rel);
  a.lengths = static_cast<const int*>(lengths);
  a.row_out = static_cast<float*>(out);
  a.sums = static_cast<float*>(out2);
  a.Sq = a.Sk = seq_len;
  a.H = num_heads;
  a.geo = Geometry{image_len,     patch_per_row, core_layers, text_max_distance,
                   image_part_id, text_part_id,  vocab,       min(window, seq_len),
                   num_global};
  a.scale = scale;
  a.dr = Dropout{static_cast<uint32_t>(dropout_threshold), keep_scale,
                 static_cast<uint32_t>(seed), 0u};
  return static_cast<int>(kVariants[variant](a, batch, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* mmt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
