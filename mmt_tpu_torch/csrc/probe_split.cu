// Split-schedule probe for Hopper (sm_90a): the relative-attention forward
// over one class of key tiles only.
//
// Replaces the TPU probe scripts/split_probe.py:one_pass, which launches
// K2's body (mmt_tpu/ops/pallas_attention.py:_fwd_list_kernel) once over
// the far list and once over the structured list of _split_tile_lists and
// times each.  The production forward (rel_attention_fwd.cu) computes the
// same function in one pass and does not specialise far tiles; this probe
// prices that specialisation on the card before the forward is redesigned.
// Nothing on the retrieval or training paths calls it.
//
// Tile classes at the kernels' 64 x 64 tiles (the rule of
// _build_tile_meta at block 64): a tile (q0, k0) is FAR when it lies in the
// text x text part (q0 >= P^2 and k0 >= P^2) and every offset j - i in it is
// beyond the text distance D on one side (k0 - (q0 + 63) > D: right, id D;
// k0 + 63 - q0 < -D: left, id 2D).  Its bias is rank-1: qr[i, D] or
// qr[i, 2D], one value per query row.  Every other tile is STRUCTURED (the
// band, the image corner, the image x text cross parts).
//
//   kFar = true : visits the far tiles of the block's row; the bias is one
//                 fused multiply-add per element with the row's value (no
//                 per-element id, no table gather).
//   kFar = false: visits the structured tiles with the production
//                 per-element path (relative_id + gather from qr).
//
// Each pass writes float32 partials: o [B, S, H, D] normalised by the
// pass's own row sum, lse [B, H, S]; a row with no tile of the class gets
// o = 0, lse = -inf, so that the caller's logsumexp combine
// (_forward_split, pallas_attention.py:1585-1590) ignores it.  Key tiles
// with k0 >= L_b and query tiles with q0 >= L_b are skipped as in the
// production kernel.  No dropout and no window: the split schedule is the
// dense retrieval path's.
//
// Bound (either pass): 4 * D * H * 64 * 64 FLOPs per visited tile plus the
// qr product, against the bytes of q, k, v read and o, lse written; at the
// retrieval shape both passes are bound by operations.

#include "rel_attention_common.cuh"

namespace {

using namespace mmt;

// 0: structured, 1: far right (id D), 2: far left (id 2D).
__device__ __forceinline__ int tile_class(int q0, int k0, const Geometry& g) {
  if (q0 < g.image_len || k0 < g.image_len) return 0;
  if (k0 - (q0 + kBQ - 1) > g.text_max_distance) return 1;
  if (k0 + kBK - 1 - q0 < -g.text_max_distance) return 2;
  return 0;
}

template <int D, bool kFar>
__global__ void __launch_bounds__(kThreads)
split_pass_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ rel,
                  const int* __restrict__ lengths, float* __restrict__ o,
                  float* __restrict__ lse, int S, int H, Geometry geo, float scale) {
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
  const int r_lo = warp * 16 + g;  // this lane's rows: r_lo and r_lo + 8

  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float o_acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) o_acc[nd][0] = o_acc[nd][1] = o_acc[nd][2] = o_acc[nd][3] = 0.f;

  if (q0 < L) {  // block-uniform
    const bool has_rel = rel != nullptr && geo.vocab > 0;
    load_tile<D>(s_q, q + head0 + static_cast<size_t>(q0) * row_stride, S - q0, row_stride);
    if (has_rel) load_tile<D>(s_k, rel + static_cast<size_t>(h) * kVP * D, kVP, D);
    __syncthreads();

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
      __syncwarp();
    }

    const int num_tiles = (L + kBK - 1) / kBK;
    for (int kt = 0; kt < num_tiles; ++kt) {
      const int k0 = kt * kBK;
      const int cls = tile_class(q0, k0, geo);  // block-uniform
      if ((cls != 0) != kFar) continue;
      __syncthreads();  // the previous tile (or R_h) is no longer read
      load_tile<D>(s_k, k + head0 + static_cast<size_t>(k0) * row_stride, S - k0, row_stride);
      load_tile_transposed<D>(s_vt, v + head0 + static_cast<size_t>(k0) * row_stride, S - k0,
                              row_stride);
      __syncthreads();

      matmul_abt<D>(acc, qa, s_k, g, t);

      if constexpr (kFar) {
        // One id for the whole tile: the bias is a per-row value, folded
        // into the scaling as one fused multiply-add per element.
        const int id = cls == 1 ? geo.text_max_distance : 2 * geo.text_max_distance;
        float av[2] = {0.f, 0.f};
        if (has_rel && id < geo.vocab) {
          av[0] = s_qr[r_lo * LDR + id] * scale;
          av[1] = s_qr[(r_lo + 8) * LDR + id] * scale;
        }
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = q0 + r_lo + (e >> 1) * 8;
            const int j = k0 + n * 8 + t * 2 + (e & 1);
            float x = fmaf(acc[n][e], scale, av[e >> 1]);
            if ((i < L) != (j < L)) x += kMaskBias;
            acc[n][e] = x;
          }
        }
      } else {
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

      matmul_pb<D>(o_acc, acc, s_vt, g, t);
    }
  }

  // A row whose class has no live tile (or a block past the length) keeps
  // l = 0: o = 0, lse = -inf.
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i = q0 + r_lo + hr * 8;
    if (i >= S) continue;
    const bool empty = l_run[hr] == 0.f;
    const float inv = empty ? 0.f : 1.f / l_run[hr];
    float* orow = o + head0 + static_cast<size_t>(i) * row_stride;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<float2*>(orow + nd * 8 + t * 2) =
          make_float2(o_acc[nd][2 * hr] * inv, o_acc[nd][2 * hr + 1] * inv);
    if (t == 0) lse_bh[i] = empty ? -INFINITY : m_run[hr] + logf(l_run[hr]);
  }
}

}  // namespace

// q, k, v: bf16 [B, S, H, 64] contiguous; rel: bf16 [H, 64, 64] contiguous
// (rows >= V zero) or null; lengths: int32 [B]; o: fp32 [B, S, H, 64];
// lse: fp32 [B, H, S].  far != 0 runs the far pass, else the structured
// pass.  Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int mmt_probe_split_pass(const void* q, const void* k, const void* v, const void* rel,
                                    const void* lengths, void* o, void* lse, int batch,
                                    int seq_len, int num_heads, int head_dim, int vocab,
                                    int image_len, int patch_per_row, int core_layers,
                                    int text_max_distance, int image_part_id, int text_part_id,
                                    float scale, int far, void* stream) {
  if (vocab < 0 || vocab > kVP || head_dim != 64) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry geo{image_len,     patch_per_row, core_layers,     text_max_distance,
                     image_part_id, text_part_id,  rel ? vocab : 0, 0, 0};
  const dim3 grid((seq_len + kBQ - 1) / kBQ, num_heads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* rp = static_cast<const __nv_bfloat16*>(rel);
  const auto* lp = static_cast<const int*>(lengths);
  auto* op = static_cast<float*>(o);
  auto* sp = static_cast<float*>(lse);
  if (far) {
    split_pass_kernel<64, true><<<grid, kThreads, 0, s>>>(qp, kp, vp, rp, lp, op, sp, seq_len,
                                                          num_heads, geo, scale);
  } else {
    split_pass_kernel<64, false><<<grid, kThreads, 0, s>>>(qp, kp, vp, rp, lp, op, sp, seq_len,
                                                           num_heads, geo, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mmt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
