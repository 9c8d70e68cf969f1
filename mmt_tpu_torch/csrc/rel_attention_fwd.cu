// Relative-bias flash attention forward for Hopper (sm_90a).
//
// Replaces the two TPU forward kernels of mmt_tpu/ops/pallas_attention.py:
//   K1 `_fwd_kernel` (rect grid, `_attention_forward`) and
//   K2 `_fwd_list_kernel` (list grid, `_run_fwd_list`, as used by the
//   far/structured split schedule `_forward_split`), together with the
//   image-corner build `_build_img_corner` and the logsumexp combine of the
//   split.  The split is a TPU schedule, not semantics: one pass here
//   computes the function both compute.  The windowed list (window > 0) is
//   not ported; the Python wrapper raises on it.
//
// What it computes, for each (batch b, head h) and query row i < S:
//   s[i, j] = (q_i . k_j + bias(i, j)) * scale          (fp32)
//   bias(i, j) = qr[i, id(i, j)] if id < V else 0,   qr = q_tile . R_h^T
//   s[i, j] += -10000 where (i < L_b) != (j < L_b)
//   o_i = softmax_j(s[i, :]) . v   (p rounded to bf16 before p.v, as the
//   TPU kernel does), lse_i = log sum_j exp(s[i, j]).
// Only key tiles with k0 < L_b run (the TPU kernel's exact pad-tile skip);
// a query tile with q0 >= L_b writes o = 0 and lse = -inf.  id(i, j) is the
// closed form of mmt_tpu_torch/features/relative_position.py: 2D patch ids
// for i, j < P^2 (on every tile that meets the image corner, which spans
// 4x4 tiles of 64 at P = 14), the part ids for image x text pairs, and the
// clipped 1D id of j - i for text x text pairs.
//
// Design: one block of 4 warps owns 64 query rows of one (b, h); each warp
// owns 16 rows.  Q fragments stay in registers; qr = q_tile . R_h^T
// ([64, 64], V <= 64, zero-padded) is computed once per block with the same
// tensor-core path as q . k^T and kept in shared memory, where the bias is
// gathered per element.  K and V tiles of 64 keys are staged in shared
// memory (V transposed), products use mma.sync m16n8k16 bf16 -> fp32, and
// the online softmax runs on the accumulator registers (row statistics
// reduced over the 4 lanes that share a row).
//
// Bound at the flagship shape (B=32, S=4096, H=12, D=64, V=49, L ~ U[2048,
// 4096]): FLOPs 4 * sum_b L_b^2 * D * H + 2 * sum_b L_b * V * D * H, about
// 0.95 TFLOP per layer, over 989 TFLOP/s = ~1.0 ms; the bytes of q, k, v and
// o are 4 * B * S * H * D * 2 = 0.4 GB over 3.35 TB/s = ~0.12 ms.  So the
// kernel is bound by operations.
//
// What the simple design leaves on the table: mma.sync instead of wgmma
// (Hopper's full tensor-core rate needs wgmma), no TMA and no
// double-buffered cp.async pipeline (loads and math do not overlap within a
// block), a per-element id computation and shared-memory gather for the
// bias on every tile (far text tiles have one id per row and could fold the
// bias into the row statistics, as the TPU split schedule does), and __expf
// on every element instead of exp2 with a folded log2(e) scale.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block (4 warps x 16 rows)
constexpr int kBK = 64;        // keys per tile
constexpr int kVP = 64;        // relative-vocab columns of qr (V <= 64, padded)
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

template <int D>
__global__ void __launch_bounds__(kThreads)
rel_attention_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ rel,
                         const int* __restrict__ lengths, __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int S, int H, Geometry geo, float scale) {
  constexpr int LD = D + kPad;
  constexpr int LDV = kBK + kPad;
  constexpr int LDR = kVP + 1;
  __shared__ __align__(16) __nv_bfloat16 s_q[kBQ * LD];
  __shared__ __align__(16) __nv_bfloat16 s_k[kBK * LD];  // R_h first, then K tiles
  __shared__ __align__(16) __nv_bfloat16 s_vt[D * LDV];
  __shared__ float s_qr[kBQ * LDR];

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int L = max(0, min(lengths[b], S));
  const size_t row_stride = static_cast<size_t>(H) * D;
  const size_t head0 = static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(h) * D;
  float* lse_bh = lse + (static_cast<size_t>(b) * H + h) * S;

  if (q0 >= L) {  // every key tile is skipped: o = 0, lse = -inf
    for (int idx = threadIdx.x; idx < kBQ * (D / 8); idx += kThreads) {
      const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
      if (q0 + r < S)
        *reinterpret_cast<uint4*>(o + head0 + static_cast<size_t>(q0 + r) * row_stride + c) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    for (int r = threadIdx.x; r < kBQ; r += kThreads)
      if (q0 + r < S) lse_bh[q0 + r] = -INFINITY;
    return;
  }

  const bool has_rel = rel != nullptr && geo.vocab > 0;
  load_tile<D>(s_q, q + head0 + static_cast<size_t>(q0) * row_stride, S - q0, row_stride);
  if (has_rel) load_tile<D>(s_k, rel + static_cast<size_t>(h) * kVP * D, kVP, D);
  __syncthreads();

  const int r_lo = warp * 16 + g;  // this lane's rows: r_lo and r_lo + 8
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* p = s_q + r_lo * LD + kk * 16 + t * 2;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(p);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(p + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
  }

  float acc[8][4];
  if (has_rel) {  // qr = q_tile . R_h^T, read back only by this warp
    matmul_abt<D>(acc, qa, s_k, g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = n * 8 + t * 2;
      s_qr[r_lo * LDR + c] = acc[n][0];
      s_qr[r_lo * LDR + c + 1] = acc[n][1];
      s_qr[(r_lo + 8) * LDR + c] = acc[n][2];
      s_qr[(r_lo + 8) * LDR + c + 1] = acc[n][3];
    }
  }

  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float o_acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) o_acc[nd][0] = o_acc[nd][1] = o_acc[nd][2] = o_acc[nd][3] = 0.f;

  const int n_tiles = (L + kBK - 1) / kBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile (or R_h) is no longer read
    load_tile<D>(s_k, k + head0 + static_cast<size_t>(k0) * row_stride, S - k0, row_stride);
    load_tile_transposed<D>(s_vt, v + head0 + static_cast<size_t>(k0) * row_stride, S - k0,
                            row_stride);
    __syncthreads();

    matmul_abt<D>(acc, qa, s_k, g, t);

#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = r_lo + (e >> 1) * 8;
        const int i = q0 + rr;
        const int j = k0 + n * 8 + t * 2 + (e & 1);
        float x = acc[n][e];
        if (has_rel) {
          const int id = relative_id(i, j, geo);
          if (id < geo.vocab) x += s_qr[rr * LDR + id];
        }
        x *= scale;
        if ((i < L) != (j < L)) x += kMaskBias;
        acc[n][e] = x;
      }
    }

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(acc[n][2 * hr], acc[n][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[hr], mx);
      const float alpha = __expf(m_run[hr] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float p = __expf(acc[n][2 * hr + u] - m_new);
          acc[n][2 * hr + u] = p;
          sum += p;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[hr] = l_run[hr] * alpha + sum;
      m_run[hr] = m_new;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        o_acc[nd][2 * hr] *= alpha;
        o_acc[nd][2 * hr + 1] *= alpha;
      }
    }

#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      const uint32_t pa[4] = {
          pack_bf16(acc[2 * kc][0], acc[2 * kc][1]),
          pack_bf16(acc[2 * kc][2], acc[2 * kc][3]),
          pack_bf16(acc[2 * kc + 1][0], acc[2 * kc + 1][1]),
          pack_bf16(acc[2 * kc + 1][2], acc[2 * kc + 1][3]),
      };
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const __nv_bfloat16* p = s_vt + (nd * 8 + g) * LDV + kc * 16 + t * 2;
        mma_16816(o_acc[nd], pa, *reinterpret_cast<const uint32_t*>(p),
                  *reinterpret_cast<const uint32_t*>(p + 8));
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i = q0 + r_lo + hr * 8;
    if (i >= S) continue;
    const float l = l_run[hr] == 0.f ? 1.f : l_run[hr];
    const float inv = 1.f / l;
    __nv_bfloat16* orow = o + head0 + static_cast<size_t>(i) * row_stride;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<uint32_t*>(orow + nd * 8 + t * 2) =
          pack_bf16(o_acc[nd][2 * hr] * inv, o_acc[nd][2 * hr + 1] * inv);
    if (t == 0) lse_bh[i] = m_run[hr] + logf(l);
  }
}

}  // namespace

// q, k, v, o: bf16 [B, S, H, D] contiguous; rel: bf16 [H, 64, D] contiguous
// (rows >= V zero) or null; lengths: int32 [B]; lse: fp32 [B, H, S].
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int mmt_rel_attention_fwd(const void* q, const void* k, const void* v, const void* rel,
                                     const void* lengths, void* o, void* lse, int batch,
                                     int seq_len, int num_heads, int head_dim, int vocab,
                                     int image_len, int patch_per_row, int core_layers,
                                     int text_max_distance, int image_part_id, int text_part_id,
                                     float scale, void* stream) {
  if (vocab < 0 || vocab > kVP) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry geo{image_len,         patch_per_row, core_layers, text_max_distance,
                     image_part_id,     text_part_id,  rel ? vocab : 0};
  const dim3 grid((seq_len + kBQ - 1) / kBQ, num_heads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* rp = static_cast<const __nv_bfloat16*>(rel);
  const auto* lp = static_cast<const int*>(lengths);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto* sp = static_cast<float*>(lse);
  if (head_dim == 64) {
    rel_attention_fwd_kernel<64><<<grid, kThreads, 0, s>>>(qp, kp, vp, rp, lp, op, sp, seq_len,
                                                           num_heads, geo, scale);
  } else if (head_dim == 32) {
    rel_attention_fwd_kernel<32><<<grid, kThreads, 0, s>>>(qp, kp, vp, rp, lp, op, sp, seq_len,
                                                           num_heads, geo, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mmt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
