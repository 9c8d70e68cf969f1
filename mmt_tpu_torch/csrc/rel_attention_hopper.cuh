// Hopper pieces shared by the relative-attention kernels
// (rel_attention_fwd.cuh, rel_attention_bwd.cu): swizzled shared-memory
// tiles read by wgmma matrix descriptors, the wgmma products, the cp.async
// copies, and the per-tile forms of the relative id and the dropout hash.
// Header-only, sm_90a; include after rel_attention_common.cuh.
#pragma once

#include "rel_attention_common.cuh"

namespace mmt {

constexpr int kT = 64;  // rows of every tile: queries, keys or vocab ids
constexpr int kMaxPatchPerRow = 32;  // the image id table holds (2P - 1)^2 bytes
constexpr int kMaxImageIds = (2 * kMaxPatchPerRow - 1) * (2 * kMaxPatchPerRow - 1) + 1;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A [64, W] bf16 tile in shared memory, rows of 2 W bytes under the
// matching swizzle (W = 64: 128-byte, 16-byte chunk c of row r at
// c ^ (r & 7); W = 32: 64-byte, c ^ ((r >> 1) & 3)): the layouts that TMA
// writes and wgmma reads.  Tiles start 1024-byte aligned.
template <int W>
struct Swz {
  static_assert(W == 64 || W == 32, "tile width");
  static constexpr int kRowBytes = 2 * W;
  static constexpr int kChunks = W / 8;
  static constexpr int kBytes = kT * kRowBytes;
  static constexpr uint64_t kLayout = W == 64 ? 1 : 2;  // descriptor: 128B / 64B swizzle
  __device__ static __forceinline__ int chunk(int r, int c) {
    const int x = W == 64 ? (r & 7) : ((r >> 1) & 3);
    return r * kRowBytes + ((c ^ x) << 4);
  }
  // Byte offset of element (r, col).
  __device__ static __forceinline__ int elem(int r, int col) {
    return chunk(r, col >> 3) + ((col & 7) << 1);
  }
  // Matrix descriptor at byte address `addr`: stride between 8-row groups
  // = 8 rows; the leading offset is unused (every operand is one swizzle
  // atom wide in its contiguous dimension).
  __device__ static __forceinline__ uint64_t desc(uint32_t addr) {
    return ((addr & 0x3FFFF) >> 4) | (1ull << 16) |
           (static_cast<uint64_t>((8 * kRowBytes) >> 4) << 32) | (kLayout << 62);
  }
  // Operand whose contiguous dimension is K (K-major): k-step kk of 16
  // elements starts 32 bytes further along the row.
  __device__ static __forceinline__ uint64_t k_major(uint32_t base, int kk) {
    return desc(base + 32 * kk);
  }
  // Operand whose rows are K (MN-major): k-step kk starts 16 rows down.
  __device__ static __forceinline__ uint64_t mn_major(uint32_t base, int kk) {
    return desc(base + 16 * kRowBytes * kk);
  }
};

// ------------------------------------------------------------- wgmma

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Generic-proxy writes to shared memory (stores, cp.async) made visible to
// wgmma's async proxy; a barrier follows.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x N fp32, N / 2 registers) += A (64 x 16) . B (16 x N).  ss: A and
// B by descriptor, TA / TB = 1 for an MN-major operand; rs: A from
// registers (the mma.sync m16n8k16 A layout, warp w holding rows 16 w..).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// ----------------------------------------------------------- cp.async

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, 64) of a [rows, D] bf16 matrix into a swizzled tile, by the
// block's kThr threads; rows >= rows_valid are zero-filled.
template <int D, int kThr = kThreads>
__device__ __forceinline__ void copy_tile(uint32_t dst, const __nv_bfloat16* src,
                                          int rows_valid, size_t row_stride) {
  using T = Swz<D>;
  for (int idx = threadIdx.x; idx < kT * T::kChunks; idx += kThr) {
    const int r = idx / T::kChunks, c = idx % T::kChunks;
    const bool ok = r < rows_valid;
    cp_async16(dst + T::chunk(r, c), ok ? src + r * row_stride + c * 8 : src, ok);
  }
}

// ------------------------------------------------------ per-pair values

// The pieces of the relative id (the closed form of
// mmt_tpu_torch/features/relative_position.py).  image_id: the 2D id of an
// image pair from dy = jy - iy and dx = jx - ix, r core layers (inside the
// core square the id (dy * d + dx) mod d^2, which is that number wrapped
// once: |dy * d + dx| < d^2; outside it one of 8 direction ids); band_id:
// the clipped 1D id of a text pair.
__device__ __forceinline__ int image_id(int dy, int dx, int r) {
  const int d = 2 * r + 1;
  const bool above = dy < -r, below = dy > r, left = dx < -r, right = dx > r;
  const bool mid_y = !above && !below, mid_x = !left && !right;
  if (mid_y && mid_x) {
    const int f = dy * d + dx;
    return f < 0 ? f + d * d : f;
  }
  const int base = d * d;
  if (above && mid_x) return base + 0;
  if (above && right) return base + 1;
  if (mid_y && right) return base + 2;
  if (below && right) return base + 3;
  if (below && mid_x) return base + 4;
  if (below && left) return base + 5;
  if (mid_y && left) return base + 6;
  return base + 7;
}

__device__ __forceinline__ int band_id(int off, int text_max_distance) {
  const int a = min(abs(off), text_max_distance);
  return off >= 0 ? a : text_max_distance + a;
}

// The one id of every pair of the tile [q0, q0 + 64) x [k0, k0 + 64), or
// -1 when ids vary: image queries x text keys, text queries x image keys,
// and text x text tiles whose every offset j - i is beyond the clip
// distance on one side (most tiles of a long sequence).
__device__ __forceinline__ int uniform_tile_id(int q0, int k0, const Geometry& g) {
  const int il = g.image_len, q1 = q0 + kT - 1, k1 = k0 + kT - 1;
  if (q1 < il) return k0 >= il ? g.text_part_id : -1;
  if (q0 < il) return -1;
  if (k1 < il) return g.image_part_id;
  if (k0 < il) return -1;
  if (k0 - q1 >= g.text_max_distance) return g.text_max_distance;
  if (q0 - k1 >= g.text_max_distance) return 2 * g.text_max_distance;
  return -1;
}

// The keep factor of mmt_tpu/ops/pallas_attention.py:_dropout_keep in
// uint32 arithmetic (the int32 products there wrap; the shifts are
// logical), 0 or keep_scale: x = row ^ j * 0x85EBCA6B, with row = i *
// 0x9E3779B9 ^ (seed_b + head * 0x27D4EB2D) hoisted per query row (xor is
// associative, so the hash is the same bit for bit).
__device__ __forceinline__ uint32_t hash_row(uint32_t seed_b, uint32_t head, uint32_t i) {
  return (i * 0x9E3779B9u) ^ (seed_b + head * 0x27D4EB2Du);
}
__device__ __forceinline__ float keep_of(const Dropout& dr, uint32_t row, uint32_t j) {
  uint32_t x = row ^ (j * 0x85EBCA6Bu);
  x ^= x >> 16;
  x *= 0x45D9F3Bu;
  x ^= x >> 15;
  x *= 0x2C1B3C6Du;
  x ^= x >> 16;
  return (x & 0xFFFFFFu) >= dr.threshold ? dr.keep_scale : 0.f;
}

}  // namespace mmt
