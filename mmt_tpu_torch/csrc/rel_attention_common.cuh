// Pieces shared by the relative-attention kernels (rel_attention_fwd.cu,
// rel_attention_bwd.cu) and the probe kernels (probe_split.cu,
// probe_op_cost.cu): the geometry and dropout arguments, the sliding-window
// pattern and its live tiles, and, for the probes, the closed-form relative
// id, the per-element dropout hash and the mma.sync tile helpers (the
// attention kernels take the per-tile forms in rel_attention_hopper.cuh).
// Header-only; every function is inlined into the kernel that uses it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mmt {

constexpr int kBQ = 64;        // query rows per tile (4 warps x 16 rows)
constexpr int kBK = 64;        // keys per tile
constexpr int kVP = 64;        // relative-vocab columns (V <= 64, padded)
constexpr int kThreads = 128;
constexpr int kPad = 8;        // bf16 row padding of shared tiles (bank spread)
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

__device__ __forceinline__ int relative_id(int i, int j, const Geometry& g) {
  if (i < g.image_len) {
    if (j >= g.image_len) return g.text_part_id;
    const int p = g.patch_per_row, r = g.core_layers, d = 2 * r + 1;
    const int dy = j / p - i / p, dx = j % p - i % p;
    const bool above = dy < -r, below = dy > r, left = dx < -r, right = dx > r;
    const bool mid_y = !above && !below, mid_x = !left && !right;
    if (mid_y && mid_x) {
      const int f = (dy * d + dx) % (d * d);
      return f < 0 ? f + d * d : f;
    }
    const int base = d * d;  // directions: top, top-right, right,
    if (above && mid_x) return base + 0;  // bottom-right, bottom,
    if (above && right) return base + 1;  // bottom-left, left, top-left
    if (mid_y && right) return base + 2;
    if (below && right) return base + 3;
    if (below && mid_x) return base + 4;
    if (below && left) return base + 5;
    if (mid_y && left) return base + 6;
    return base + 7;
  }
  if (j < g.image_len) return g.image_part_id;
  const int off = j - i;
  const int a = min(abs(off), g.text_max_distance);
  return off >= 0 ? a : g.text_max_distance + a;
}

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

// The keep factor of mmt_tpu/ops/pallas_attention.py:_dropout_keep, in
// uint32 arithmetic (the int32 products there wrap; the shifts are
// logical).  Returns 0 or keep_scale.
__device__ __forceinline__ float dropout_keep(const Dropout& dr, uint32_t seed_b, uint32_t head,
                                              uint32_t i, uint32_t j) {
  uint32_t x = i * 0x9E3779B9u;
  x ^= j * 0x85EBCA6Bu;
  x ^= seed_b + head * 0x27D4EB2Du;
  x ^= x >> 16;
  x *= 0x45D9F3Bu;
  x ^= x >> 15;
  x *= 0x2C1B3C6Du;
  x ^= x >> 16;
  return (x & 0xFFFFFFu) >= dr.threshold ? dr.keep_scale : 0.f;
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [0, 64) of a [rows, D] tile into shared memory (row stride D + kPad);
// rows >= rows_valid are zero.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int rows_valid, size_t row_stride) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < 64 * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid) val = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + c) = val;
  }
}

// The same tile stored transposed: dst[c][r] (row stride kBK + kPad).
template <int D>
__device__ __forceinline__ void load_tile_transposed(__nv_bfloat16* dst,
                                                     const __nv_bfloat16* src,
                                                     int rows_valid, size_t row_stride) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < kBK * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid) val = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
    for (int u = 0; u < 8; ++u) dst[(c + u) * (kBK + kPad) + r] = e[u];
  }
}

// A fragments (16 rows from row0, all D columns) of a shared [64, D] tile.
template <int D>
__device__ __forceinline__ void load_a_fragments(uint32_t (&a)[D / 16][4],
                                                 const __nv_bfloat16* tile, int row0, int t) {
  constexpr int LD = D + kPad;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* p = tile + row0 * LD + kk * 16 + t * 2;
    a[kk][0] = *reinterpret_cast<const uint32_t*>(p);
    a[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
    a[kk][2] = *reinterpret_cast<const uint32_t*>(p + 8);
    a[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
  }
}

// acc[n] = A . B^T for this warp's 16 rows: A in registers (16 x D), B a
// [64, D] shared tile whose rows are the 64 output columns.
template <int D>
__device__ __forceinline__ void matmul_abt(float (&acc)[8][4], uint32_t (&a)[D / 16][4],
                                           const __nv_bfloat16* b_tile, int g, int t) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* p = b_tile + (n * 8 + g) * (D + kPad) + kk * 16 + t * 2;
      mma_16816(acc[n], a[kk], *reinterpret_cast<const uint32_t*>(p),
                *reinterpret_cast<const uint32_t*>(p + 8));
    }
  }
}

// out[nd] += P . B for this warp's 16 rows, P the 16 x 64 accumulator tile
// `p` rounded to bf16 (as A fragments), B a shared tile stored transposed
// ([D][kBK + kPad]: row = output column, contiguous along the 64 keys).
template <int D>
__device__ __forceinline__ void matmul_pb(float (&out)[D / 8][4], const float (&p)[8][4],
                                          const __nv_bfloat16* bt_tile, int g, int t) {
  constexpr int LDV = kBK + kPad;
#pragma unroll
  for (int kc = 0; kc < kBK / 16; ++kc) {
    const uint32_t pa[4] = {
        pack_bf16(p[2 * kc][0], p[2 * kc][1]),
        pack_bf16(p[2 * kc][2], p[2 * kc][3]),
        pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]),
        pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3]),
    };
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const __nv_bfloat16* q = bt_tile + (nd * 8 + g) * LDV + kc * 16 + t * 2;
      mma_16816(out[nd], pa, *reinterpret_cast<const uint32_t*>(q),
                *reinterpret_cast<const uint32_t*>(q + 8));
    }
  }
}

}  // namespace mmt
