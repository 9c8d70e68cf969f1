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
// Attention dropout (K1's in-kernel dropout, pallas_attention.py:1740-1751)
// multiplies p in fp32 by the keep factor of the hash (dropout_keep in
// rel_attention_common.cuh) after p has entered the row sum l and before
// the bf16 rounding for p.v, so lse is unchanged by dropout.  The dropout is
// a template argument: at rate 0 the kernel is the one without dropout.
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

#include "rel_attention_common.cuh"

namespace {

using namespace mmt;

template <int D, bool kDropout>
__global__ void __launch_bounds__(kThreads)
rel_attention_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ rel,
                         const int* __restrict__ lengths, __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int S, int H, Geometry geo, float scale,
                         Dropout dr) {
  constexpr int LD = D + kPad;
  constexpr int LDR = kVP + 1;
  __shared__ __align__(16) __nv_bfloat16 s_q[kBQ * LD];
  __shared__ __align__(16) __nv_bfloat16 s_k[kBK * LD];  // R_h first, then K tiles
  __shared__ __align__(16) __nv_bfloat16 s_vt[D * (kBK + kPad)];
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
  load_a_fragments<D>(qa, s_q, warp * 16 + g, t);

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
  const uint32_t seed_b = kDropout ? example_seed(dr, b) : 0u;

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

    if constexpr (kDropout) {  // after l has the full sum; only p.v sees the mask
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t i = q0 + r_lo + (e >> 1) * 8;
          const uint32_t j = k0 + n * 8 + t * 2 + (e & 1);
          acc[n][e] *= dropout_keep(dr, seed_b, h, i, j);
        }
      }
    }

    matmul_pb<D>(o_acc, acc, s_vt, g, t);
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

template <int D, bool kDropout>
void launch(dim3 grid, cudaStream_t s, const __nv_bfloat16* q, const __nv_bfloat16* k,
            const __nv_bfloat16* v, const __nv_bfloat16* rel, const int* lengths,
            __nv_bfloat16* o, float* lse, int S, int H, const Geometry& geo, float scale,
            const Dropout& dr) {
  rel_attention_fwd_kernel<D, kDropout><<<grid, kThreads, 0, s>>>(q, k, v, rel, lengths, o, lse,
                                                                   S, H, geo, scale, dr);
}

}  // namespace

// q, k, v, o: bf16 [B, S, H, D] contiguous; rel: bf16 [H, 64, D] contiguous
// (rows >= V zero) or null; lengths: int32 [B]; lse: fp32 [B, H, S].
// dropout_threshold = round(rate * 2^24) (0: no dropout), keep_scale =
// float32(1 / (1 - rate)), seed: the call's int32 seed, batch_start: global
// index of example 0.  Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int mmt_rel_attention_fwd(const void* q, const void* k, const void* v, const void* rel,
                                     const void* lengths, void* o, void* lse, int batch,
                                     int seq_len, int num_heads, int head_dim, int vocab,
                                     int image_len, int patch_per_row, int core_layers,
                                     int text_max_distance, int image_part_id, int text_part_id,
                                     float scale, int dropout_threshold, float keep_scale,
                                     int seed, int batch_start, void* stream) {
  if (vocab < 0 || vocab > kVP || dropout_threshold < 0 || dropout_threshold > (1 << 24))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry geo{image_len,         patch_per_row, core_layers, text_max_distance,
                     image_part_id,     text_part_id,  rel ? vocab : 0};
  const Dropout dr{static_cast<uint32_t>(dropout_threshold), keep_scale,
                   static_cast<uint32_t>(seed), static_cast<uint32_t>(batch_start)};
  const dim3 grid((seq_len + kBQ - 1) / kBQ, num_heads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* rp = static_cast<const __nv_bfloat16*>(rel);
  const auto* lp = static_cast<const int*>(lengths);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto* sp = static_cast<float*>(lse);
  const bool drop = dropout_threshold > 0;
  if (head_dim == 64) {
    (drop ? launch<64, true> : launch<64, false>)(grid, s, qp, kp, vp, rp, lp, op, sp, seq_len,
                                                  num_heads, geo, scale, dr);
  } else if (head_dim == 32) {
    (drop ? launch<32, true> : launch<32, false>)(grid, s, qp, kp, vp, rp, lp, op, sp, seq_len,
                                                  num_heads, geo, scale, dr);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mmt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
