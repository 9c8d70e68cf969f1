// Relative-bias flash attention backward for Hopper (sm_90a): two kernels,
// one per pass, in the FlashAttention-2 style.
//
// Replaces the TPU backward kernels of mmt_tpu/ops/pallas_attention.py:
//   K3 `_bwd_fused_kernel` (the default one-pass backward, body
//   `_bwd_tile_core`, dRel via `_tile_dsv_multi`) and
//   K5 `_bwd_dq_kernel` + `_bwd_dkv_kernel` (the two-pass backward,
//   MMT_ATTN_BWD=split).
// K3 keeps dk/dv for the whole key length in VMEM scratch ([hb, nk, bk, D]
// fp32, 4 MB at S=4096); a Hopper block has at most 227 KB of shared memory
// and blocks run in no order, so the schedule here is K5's: pass 1 owns 64
// query rows and sweeps the keys (dq, dRel), pass 2 owns 64 keys and sweeps
// the queries (dk, dv).  Both compute the function K3 computes.
//
// What they compute, per (b, h), with s the forward's scaled, masked logits
// (same bias, mask and dropout hash as rel_attention_fwd.cu), lse and
// delta = rowsum(do * o) from the caller, K the dropout keep factor and
// "real" = (i < L_b) and (j < L_b):
//   p = exp(s - lse)  (lse < -1e38 clamped to 3e38, as at :2074)
//   dS = real ? p * (do_i . v_j * K - delta_i) : 0
//   dq_i = scale * (sum_j dS_ij k_j + sum_v dSV[i, v] R_h[v]),
//          dSV[i, v] = sum_{j: id(i, j) = v < V} dS_ij
//   dRel_b[h, v] = scale * sum_i dSV[i, v] q_i      (per example; the
//          caller sums over b, as at :2972)
//   dk_j = scale * sum_i dS_ij q_i,   dv_j = sum_i (real ? p * K : 0) do_i
// Only tiles with real queries and real keys run (the TPU kernels' exact
// pad-tile skip); dq/dk/dv rows past the length come out 0.
//
// Design: 4 warps per block, 16 rows per warp, mma.sync m16n8k16 bf16 ->
// fp32 as in the forward.  Pass 1 (grid: 64-query tile, head, example):
// q and do fragments stay in registers, qr = q . R_h^T is computed once into
// shared memory for the bias gather, K (row-major and transposed) and V
// tiles stream through shared memory; ds is formed on the accumulator
// registers and rounded to bf16 for ds . K; dSV is accumulated in a
// [64, 64] fp32 shared tile by shared-memory atomics, merging runs of equal
// ids along a row first (far text tiles have one id per row); at the end
// dq += dSV . R_h and dSV^T . q run in fp32 FMAs, and dRel goes to a
// [B, H, 64, D] fp32 buffer by global atomics (one per (v, d) per query
// tile; the order of those adds varies from run to run, so dRel is held to
// a relative bound, not bit-for-bit).  Pass 2 (grid: 64-key tile, head,
// example): k and v fragments (and R_h's, for qr^T = R_h . Q^T per query
// tile) stay in registers, Q and dO tiles stream in row-major and
// transposed form; p * K and dS are rounded to bf16 for the dv and dk
// products.
//
// Bound (H100 SXM: 989 TFLOP/s dense bf16, 3.35 TB/s): operations
// 10 * sum_b L_b^2 * D * H (q.k^T and do.v^T in both passes counted once
// each, ds.k, p^T.do, ds^T.q) + 6 * sum_b L_b * V * D * H (q.R^T, dsv.R,
// dsv^T.q); bytes: q, k, v, do read once, dq, dk, dv written once, lse and
// delta read once.  At B=32, S=4096, L ~ U[2048, 4096], H=12, D=64, the L^2
// term is ~2.4 TFLOP -> ~2.4 ms, bytes ~0.2 ms: bound by operations.  At
// the pretraining micro-batch (B=64, S=256, L ~ U[204, 256]) the operations
// are ~26 GFLOP (~0.03 ms) and the bytes ~0.18 GB (~0.05 ms): bound by
// bytes.
//
// What the simple design leaves on the table: mma.sync instead of wgmma, no
// TMA or cp.async pipeline, the logits and the bias gather recomputed in
// both passes (K3 on the TPU pays them once), transposed tiles written
// element by element into shared memory (bank conflicts), and per-element
// id and hash arithmetic.

#include "rel_attention_common.cuh"

namespace {

using namespace mmt;

constexpr int LDR = kVP + 1;  // fp32 row stride of the [64, 64] qr / dSV tiles
constexpr int LDQ = kBQ + 1;  // fp32 row stride of the [64, 64] qr^T tile

struct BwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;
  const float* delta;
  const __nv_bfloat16* rel;  // [H, 64, D], rows >= V zero; null without bias
  const int* lengths;
  __nv_bfloat16* out0;  // dq (pass 1) or dk (pass 2)
  __nv_bfloat16* out1;  // dv (pass 2)
  float* drel;          // [B, H, 64, D] fp32, zeroed by the caller (pass 1)
  int S, H;
  Geometry geo;
  float scale;
  Dropout dr;
};

template <int D>
constexpr size_t dq_smem_bytes() {
  return (3 * kBQ * (D + kPad) + D * (kBK + kPad)) * sizeof(__nv_bfloat16) +
         2 * kBQ * LDR * sizeof(float);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return (2 * kBQ * (D + kPad) + 2 * D * (kBQ + kPad)) * sizeof(__nv_bfloat16) +
         (kVP * LDQ + 2 * kBQ) * sizeof(float);
}

// Zeroes rows [r0, r0 + 64) of a [S, H*D] bf16 tensor's head slice.
template <int D>
__device__ __forceinline__ void zero_rows(__nv_bfloat16* dst, int r0, int S, size_t row_stride) {
  for (int idx = threadIdx.x; idx < 64 * (D / 8); idx += kThreads) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    if (r0 + r < S)
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r0 + r) * row_stride + c) =
          make_uint4(0u, 0u, 0u, 0u);
  }
}

// Pass 1: dq and the per-example dRel.  Grid (query tiles, H, B).
template <int D, bool kDropout>
__global__ void __launch_bounds__(kThreads) rel_attention_bwd_dq_kernel(BwdArgs a) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem);  // [64][LD]
  __nv_bfloat16* s_k = s_q + kBQ * LD;   // [64][LD]: R_h, then K tiles, then R_h
  __nv_bfloat16* s_v = s_k + kBK * LD;   // [64][LD]: dO, then V tiles
  __nv_bfloat16* s_kt = s_v + kBK * LD;  // [D][kBK + kPad]: K^T tiles
  float* s_qr = reinterpret_cast<float*>(s_kt + D * (kBK + kPad));  // [64][LDR]
  float* s_dsv = s_qr + kBQ * LDR;                                   // [64][LDR]

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int S = a.S, H = a.H;
  const Geometry& geo = a.geo;
  const int L = max(0, min(a.lengths[b], S));
  const size_t row_stride = static_cast<size_t>(H) * D;
  const size_t head0 = static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(h) * D;
  const size_t stat0 = (static_cast<size_t>(b) * H + h) * S;

  if (q0 >= L) {  // no live tile: dq = 0 and no dRel contribution
    zero_rows<D>(a.out0 + head0, q0, S, row_stride);
    return;
  }

  const bool has_rel = a.rel != nullptr && geo.vocab > 0;
  load_tile<D>(s_q, a.q + head0 + static_cast<size_t>(q0) * row_stride, S - q0, row_stride);
  load_tile<D>(s_v, a.dout + head0 + static_cast<size_t>(q0) * row_stride, S - q0, row_stride);
  if (has_rel) load_tile<D>(s_k, a.rel + static_cast<size_t>(h) * kVP * D, kVP, D);
  for (int idx = threadIdx.x; idx < kBQ * LDR; idx += kThreads) s_dsv[idx] = 0.f;
  __syncthreads();

  const int r_lo = warp * 16 + g;  // this lane's rows: r_lo and r_lo + 8
  uint32_t qa[D / 16][4], da[D / 16][4];
  load_a_fragments<D>(qa, s_q, r_lo, t);
  load_a_fragments<D>(da, s_v, r_lo, t);

  float acc[8][4], dp[8][4];
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
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i = q0 + r_lo + hr * 8;
    const float l = i < S ? a.lse[stat0 + i] : 0.f;
    lse_r[hr] = l < -1e38f ? 3e38f : l;
    delta_r[hr] = i < S ? a.delta[stat0 + i] : 0.f;
  }
  const uint32_t seed_b = kDropout ? example_seed(a.dr, b) : 0u;

  float dq_acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
    dq_acc[nd][0] = dq_acc[nd][1] = dq_acc[nd][2] = dq_acc[nd][3] = 0.f;

  const int n_tiles = (L + kBK - 1) / kBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    const size_t off = head0 + static_cast<size_t>(k0) * row_stride;
    __syncthreads();  // the previous tiles (or R_h, dO) are no longer read
    load_tile<D>(s_k, a.k + off, S - k0, row_stride);
    load_tile_transposed<D>(s_kt, a.k + off, S - k0, row_stride);
    load_tile<D>(s_v, a.v + off, S - k0, row_stride);
    __syncthreads();

    matmul_abt<D>(acc, qa, s_k, g, t);  // q . k^T
    matmul_abt<D>(dp, da, s_v, g, t);   // do . v^T

    int run_id[2] = {-1, -1};  // pending dSV add per row: (id, sum)
    float run_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        const int rr = r_lo + hr * 8;
        const int i = q0 + rr;
        const int j = k0 + n * 8 + t * 2 + (e & 1);
        float x = acc[n][e];
        int id = kVP;
        if (has_rel) {
          id = relative_id(i, j, geo);
          if (id < geo.vocab) x += s_qr[rr * LDR + id];
        }
        x *= a.scale;
        if ((i < L) != (j < L)) x += kMaskBias;
        const float p = __expf(x - lse_r[hr]);
        float dpv = dp[n][e];
        if constexpr (kDropout) dpv *= dropout_keep(a.dr, seed_b, h, i, j);
        const float ds = (i < L && j < L) ? p * (dpv - delta_r[hr]) : 0.f;
        acc[n][e] = ds;
        if (has_rel) {  // j ascends along the row: merge runs of equal ids
          if (id != run_id[hr]) {
            if (run_id[hr] >= 0 && run_id[hr] < geo.vocab)
              atomicAdd(&s_dsv[rr * LDR + run_id[hr]], run_sum[hr]);
            run_id[hr] = id;
            run_sum[hr] = ds;
          } else {
            run_sum[hr] += ds;
          }
        }
      }
    }
    if (has_rel) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        if (run_id[hr] >= 0 && run_id[hr] < geo.vocab)
          atomicAdd(&s_dsv[(r_lo + hr * 8) * LDR + run_id[hr]], run_sum[hr]);
    }

    matmul_pb<D>(dq_acc, acc, s_kt, g, t);  // dq += ds . K
  }

  if (has_rel) {
    __syncthreads();  // every dSV add is done; s_k is free
    load_tile<D>(s_k, a.rel + static_cast<size_t>(h) * kVP * D, kVP, D);
    __syncthreads();
    // dq += dSV . R_h, in fp32 over the vocabulary columns.
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float* dsv_row = s_dsv + (r_lo + hr * 8) * LDR;
      for (int vv = 0; vv < geo.vocab; ++vv) {
        const float w = dsv_row[vv];
        const __nv_bfloat16* r_row = s_k + vv * LD + t * 2;
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          dq_acc[nd][2 * hr] += w * __bfloat162float(r_row[nd * 8]);
          dq_acc[nd][2 * hr + 1] += w * __bfloat162float(r_row[nd * 8 + 1]);
        }
      }
    }
    // dRel_b[h, v, d] += scale * sum_r dSV[r, v] * q[r, d]
    float* drel_bh = a.drel + (static_cast<size_t>(b) * H + h) * kVP * D;
    for (int idx = threadIdx.x; idx < geo.vocab * D; idx += kThreads) {
      const int vv = idx / D, d = idx % D;
      float sum = 0.f;
      for (int r = 0; r < kBQ; ++r) sum += s_dsv[r * LDR + vv] * __bfloat162float(s_q[r * LD + d]);
      atomicAdd(drel_bh + vv * D + d, sum * a.scale);
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i = q0 + r_lo + hr * 8;
    if (i >= S) continue;
    __nv_bfloat16* row = a.out0 + head0 + static_cast<size_t>(i) * row_stride;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<uint32_t*>(row + nd * 8 + t * 2) =
          pack_bf16(dq_acc[nd][2 * hr] * a.scale, dq_acc[nd][2 * hr + 1] * a.scale);
  }
}

// Pass 2: dk and dv.  Grid (key tiles, H, B).  The accumulators hold
// transposed tiles: rows are this block's keys, columns the queries.
template <int D, bool kDropout>
__global__ void __launch_bounds__(kThreads) rel_attention_bwd_dkv_kernel(BwdArgs a) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem);  // [64][LD]: K, then Q tiles
  __nv_bfloat16* s_do = s_q + kBQ * LD;    // [64][LD]: V, then dO tiles
  __nv_bfloat16* s_qt = s_do + kBQ * LD;   // [D][kBQ + kPad]: R_h, then Q^T tiles
  __nv_bfloat16* s_dot = s_qt + D * (kBQ + kPad);  // [D][kBQ + kPad]: dO^T tiles
  float* s_qrt = reinterpret_cast<float*>(s_dot + D * (kBQ + kPad));  // [kVP][LDQ]
  float* s_lse = s_qrt + kVP * LDQ;  // [64]
  float* s_delta = s_lse + kBQ;      // [64]

  const int k0 = blockIdx.x * kBK, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int S = a.S, H = a.H;
  const Geometry& geo = a.geo;
  const int L = max(0, min(a.lengths[b], S));
  const size_t row_stride = static_cast<size_t>(H) * D;
  const size_t head0 = static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(h) * D;
  const size_t stat0 = (static_cast<size_t>(b) * H + h) * S;

  if (k0 >= L) {  // padded keys: dk = dv = 0
    zero_rows<D>(a.out0 + head0, k0, S, row_stride);
    zero_rows<D>(a.out1 + head0, k0, S, row_stride);
    return;
  }

  const bool has_rel = a.rel != nullptr && geo.vocab > 0;
  load_tile<D>(s_q, a.k + head0 + static_cast<size_t>(k0) * row_stride, S - k0, row_stride);
  load_tile<D>(s_do, a.v + head0 + static_cast<size_t>(k0) * row_stride, S - k0, row_stride);
  // R_h as a [64][LD] tile over s_qt and s_dot (2 * D * (kBQ + kPad) >= 64 * LD).
  if (has_rel) load_tile<D>(s_qt, a.rel + static_cast<size_t>(h) * kVP * D, kVP, D);
  __syncthreads();

  const int r_lo = warp * 16 + g;  // this lane's keys (or vocab rows): r_lo, r_lo + 8
  uint32_t ka[D / 16][4], va[D / 16][4], ra[D / 16][4];
  load_a_fragments<D>(ka, s_q, r_lo, t);
  load_a_fragments<D>(va, s_do, r_lo, t);
  if (has_rel) load_a_fragments<D>(ra, s_qt, r_lo, t);
  const uint32_t seed_b = kDropout ? example_seed(a.dr, b) : 0u;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    dk_acc[nd][0] = dk_acc[nd][1] = dk_acc[nd][2] = dk_acc[nd][3] = 0.f;
    dv_acc[nd][0] = dv_acc[nd][1] = dv_acc[nd][2] = dv_acc[nd][3] = 0.f;
  }

  float acc[8][4], dp[8][4];
  const int n_tiles = (L + kBQ - 1) / kBQ;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * kBQ;
    const size_t off = head0 + static_cast<size_t>(q0) * row_stride;
    __syncthreads();  // the previous tiles (or K, V, R_h) are no longer read
    load_tile<D>(s_q, a.q + off, S - q0, row_stride);
    load_tile_transposed<D>(s_qt, a.q + off, S - q0, row_stride);
    load_tile<D>(s_do, a.dout + off, S - q0, row_stride);
    load_tile_transposed<D>(s_dot, a.dout + off, S - q0, row_stride);
    for (int r = threadIdx.x; r < kBQ; r += kThreads) {
      const int i = q0 + r;
      const float l = i < S ? a.lse[stat0 + i] : 0.f;
      s_lse[r] = l < -1e38f ? 3e38f : l;
      s_delta[r] = i < S ? a.delta[stat0 + i] : 0.f;
    }
    __syncthreads();

    if (has_rel) {  // qr^T = R_h . Q^T: row v, column = query; read by every warp
      matmul_abt<D>(acc, ra, s_q, g, t);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = n * 8 + t * 2;
        s_qrt[r_lo * LDQ + c] = acc[n][0];
        s_qrt[r_lo * LDQ + c + 1] = acc[n][1];
        s_qrt[(r_lo + 8) * LDQ + c] = acc[n][2];
        s_qrt[(r_lo + 8) * LDQ + c + 1] = acc[n][3];
      }
      __syncthreads();
    }

    matmul_abt<D>(acc, ka, s_q, g, t);  // s^T = k . q^T
    matmul_abt<D>(dp, va, s_do, g, t);  // dp^T = v . do^T

#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + r_lo + (e >> 1) * 8;
        const int c = n * 8 + t * 2 + (e & 1);
        const int i = q0 + c;
        float x = acc[n][e];
        if (has_rel) {
          const int id = relative_id(i, j, geo);
          if (id < geo.vocab) x += s_qrt[id * LDQ + c];
        }
        x *= a.scale;
        if ((i < L) != (j < L)) x += kMaskBias;
        const float p = __expf(x - s_lse[c]);
        float keep = 1.f;
        if constexpr (kDropout) keep = dropout_keep(a.dr, seed_b, h, i, j);
        const bool real = i < L && j < L;
        acc[n][e] = real ? p * keep : 0.f;                        // dropped p, for dv
        dp[n][e] = real ? p * (dp[n][e] * keep - s_delta[c]) : 0.f;  // dS
      }
    }

    matmul_pb<D>(dv_acc, acc, s_dot, g, t);  // dv += (p K)^T . do
    matmul_pb<D>(dk_acc, dp, s_qt, g, t);    // dk += dS^T . q
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int j = k0 + r_lo + hr * 8;
    if (j >= S) continue;
    __nv_bfloat16* dk_row = a.out0 + head0 + static_cast<size_t>(j) * row_stride;
    __nv_bfloat16* dv_row = a.out1 + head0 + static_cast<size_t>(j) * row_stride;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      *reinterpret_cast<uint32_t*>(dk_row + nd * 8 + t * 2) =
          pack_bf16(dk_acc[nd][2 * hr] * a.scale, dk_acc[nd][2 * hr + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(dv_row + nd * 8 + t * 2) =
          pack_bf16(dv_acc[nd][2 * hr], dv_acc[nd][2 * hr + 1]);
    }
  }
}

template <int D, bool kDropout>
cudaError_t launch(bool dq_pass, dim3 grid, cudaStream_t s, const BwdArgs& a) {
  auto kernel = dq_pass ? rel_attention_bwd_dq_kernel<D, kDropout>
                        : rel_attention_bwd_dkv_kernel<D, kDropout>;
  const size_t smem = dq_pass ? dq_smem_bytes<D>() : dkv_smem_bytes<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

int run(bool dq_pass, const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, const void* rel, const void* lengths, void* out0,
        void* out1, void* drel, int batch, int seq_len, int num_heads, int head_dim, int vocab,
        int image_len, int patch_per_row, int core_layers, int text_max_distance,
        int image_part_id, int text_part_id, float scale, int dropout_threshold,
        float keep_scale, int seed, int batch_start, void* stream) {
  if (vocab < 0 || vocab > kVP || dropout_threshold < 0 || dropout_threshold > (1 << 24))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dq_pass && rel != nullptr && vocab > 0 && drel == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.rel = static_cast<const __nv_bfloat16*>(rel);
  a.lengths = static_cast<const int*>(lengths);
  a.out0 = static_cast<__nv_bfloat16*>(out0);
  a.out1 = static_cast<__nv_bfloat16*>(out1);
  a.drel = static_cast<float*>(drel);
  a.S = seq_len;
  a.H = num_heads;
  a.geo = Geometry{image_len,     patch_per_row, core_layers, text_max_distance,
                   image_part_id, text_part_id,  rel ? vocab : 0};
  a.scale = scale;
  a.dr = Dropout{static_cast<uint32_t>(dropout_threshold), keep_scale,
                 static_cast<uint32_t>(seed), static_cast<uint32_t>(batch_start)};
  const dim3 grid((seq_len + kBQ - 1) / kBQ, num_heads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = dropout_threshold > 0;
  cudaError_t err;
  if (head_dim == 64) {
    err = drop ? launch<64, true>(dq_pass, grid, s, a) : launch<64, false>(dq_pass, grid, s, a);
  } else if (head_dim == 32) {
    err = drop ? launch<32, true>(dq_pass, grid, s, a) : launch<32, false>(dq_pass, grid, s, a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // namespace

// q, k, v, do, dq, dk, dv: bf16 [B, S, H, D] contiguous; lse, delta: fp32
// [B, H, S]; rel: bf16 [H, 64, D] (rows >= V zero) or null; lengths: int32
// [B]; drel: fp32 [B, H, 64, D], zeroed by the caller (null without rel).
// Dropout arguments as in mmt_rel_attention_fwd.  Each launches one kernel
// on `stream`, allocates nothing and returns the CUDA error code.
extern "C" int mmt_rel_attention_bwd_dq(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        const void* rel, const void* lengths, void* dq,
                                        void* drel, int batch, int seq_len, int num_heads,
                                        int head_dim, int vocab, int image_len,
                                        int patch_per_row, int core_layers,
                                        int text_max_distance, int image_part_id,
                                        int text_part_id, float scale, int dropout_threshold,
                                        float keep_scale, int seed, int batch_start,
                                        void* stream) {
  return run(true, q, k, v, dout, lse, delta, rel, lengths, dq, nullptr, drel, batch, seq_len,
             num_heads, head_dim, vocab, image_len, patch_per_row, core_layers,
             text_max_distance, image_part_id, text_part_id, scale, dropout_threshold,
             keep_scale, seed, batch_start, stream);
}

extern "C" int mmt_rel_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse, const void* delta,
                                         const void* rel, const void* lengths, void* dk,
                                         void* dv, int batch, int seq_len, int num_heads,
                                         int head_dim, int vocab, int image_len,
                                         int patch_per_row, int core_layers,
                                         int text_max_distance, int image_part_id,
                                         int text_part_id, float scale, int dropout_threshold,
                                         float keep_scale, int seed, int batch_start,
                                         void* stream) {
  return run(false, q, k, v, dout, lse, delta, rel, lengths, dk, dv, nullptr, batch, seq_len,
             num_heads, head_dim, vocab, image_len, patch_per_row, core_layers,
             text_max_distance, image_part_id, text_part_id, scale, dropout_threshold,
             keep_scale, seed, batch_start, stream);
}

extern "C" const char* mmt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
