// Pieces shared by the relative-attention kernels (rel_attention_fwd.cuh,
// rel_attention_bwd.cu): the geometry and dropout arguments, the
// sliding-window pattern and its live tiles, the per-example dropout seed
// and the bf16 pair packing (the per-tile forms of the relative id and the
// dropout hash are in rel_attention_hopper.cuh).  Header-only; every
// function is inlined into the kernel that uses it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mmt {

constexpr int kVP = 64;        // relative-vocab columns (V <= 64, padded)
constexpr int kThreads = 128;  // one warpgroup
constexpr float kMaskBias = -10000.0f;

struct Geometry {
  int image_len;          // P^2 for the 2D scheme, 0 for 1D ids only
  int patch_per_row;      // P
  int core_layers;        // r
  int text_max_distance;  // clip distance of the 1D ids
  int image_part_id;
  int text_part_id;
  int vocab;              // V; ids >= V give zero bias; 0 = no bias
  int window;             // > 0: sliding-window pattern (|i - j| <= window)
  int num_global;         // ... plus the global prefix [0, num_global)
};

// Attention-dropout parameters: keep iff the hash's low 24 bits are >=
// `threshold` (= round(rate * 2^24)); kept probabilities are multiplied by
// `keep_scale` (= float32(1 / (1 - rate))).
struct Dropout {
  uint32_t threshold;
  float keep_scale;
  uint32_t seed;         // the call's int32 seed, as uint32
  uint32_t batch_start;  // global index of the call's example 0
};

// The sliding-window + prefix-global pattern (pallas_attention.py:
// _apply_window_mask): pair (i, j) is allowed iff i < g, j < g or
// |i - j| <= window.  A disallowed pair gets kMaskBias on its scaled logit,
// after the length mask.
__device__ __forceinline__ bool window_allowed(int i, int j, const Geometry& g) {
  return i < g.num_global || j < g.num_global || abs(i - j) <= g.window;
}

// The 64-wide tiles that one block of 64 rows starting at r0 visits on the
// other axis, as global tile indexes: tiles [first, head), then [band_lo,
// band_hi), all in [first, ceil(L / 64)), where `first` is the first tile
// of the other axis's chunk (its global start / 64; 0 without offsets) and
// L the end of its real positions.  The pattern is symmetric in (i, j), so
// the same rule gives a query block's key tiles and a key block's query
// tiles.  Dense: every tile of that range.  Windowed: every tile when the
// block meets the global prefix (r0 < g); else the global tiles [first,
// ceil(g / 64)) and the band [floor((r0 - w) / 64), floor((r0 + 63 + w) /
// 64)], a tile in both visited once.  A tile left out holds no allowed pair
// (_window_tile_contributes), so the skip is exact; without offsets every
// real row keeps its diagonal tile.  Tiles come in ascending order, so at a
// window >= S the windowed kernels visit the dense kernels' tiles in their
// order.
struct LiveTiles {
  int first, head, band_lo, band_hi;
  __device__ __forceinline__ int count() const { return head - first + band_hi - band_lo; }
  __device__ __forceinline__ int tile(int n) const {
    return n < head - first ? first + n : band_lo + n - (head - first);
  }
};

template <bool kWindow>
__device__ __forceinline__ LiveTiles live_tiles(int r0, int L, const Geometry& g, int first) {
  const int n = (L + 63) / 64;
  if (!kWindow || r0 < g.num_global) return {first, max(first, n), n, n};
  const int head = max(first, min((g.num_global + 63) / 64, n));
  const int lo = max(max(r0 - g.window, 0) / 64, head);
  const int hi = min((r0 + 63 + g.window) / 64 + 1, n);
  return {first, head, lo, max(lo, hi)};
}

// Per-example seed: seed + b * -1771729351 in 32-bit wrap-around.
__device__ __forceinline__ uint32_t example_seed(const Dropout& dr, int b) {
  return dr.seed + (dr.batch_start + static_cast<uint32_t>(b)) *
                       static_cast<uint32_t>(-1771729351);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace mmt
