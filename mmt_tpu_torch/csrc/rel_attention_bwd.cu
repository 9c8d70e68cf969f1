// Relative-bias flash attention backward for Hopper (sm_90a): one kernel,
// one pass over each (query, key) pair, in the FlashAttention-2/-3 style.
//
// Replaces the TPU backward kernels of mmt_tpu/ops/pallas_attention.py:
//   K3 `_bwd_fused_kernel` (the default one-pass backward, body
//   `_bwd_tile_core`, dRel via `_tile_dsv_multi`, summed over the batch
//   outside the kernel),
//   K5 `_bwd_dq_kernel` + `_bwd_dkv_kernel` (the two-pass backward,
//   MMT_ATTN_BWD=split), and their sliding-window forms over the static
//   live-tile lists (`_backward_window_list`):
//   K4 `_bwd_fused_list_kernel` (the default) and
//   K6 `_bwd_dq_list_kernel` + `_bwd_dkv_list_kernel` (split).
// K3 keeps dk/dv for the whole key length in VMEM scratch and walks the
// grid in order; a Hopper block has at most 227 KB of shared memory and
// blocks run in no order, so here a block owns 64 keys and sweeps their
// live query tiles (LiveTiles in rel_attention_common.cuh, ascending: for
// a dense or global key block every query tile below the length, else the
// global query tiles and the band), keeping dk and dv in registers, and
// adds each tile's dq into an fp32 buffer with vector reductions.  With
// the window (a template argument, as the dropout is) the sweep is K6's
// k-sorted list computed per block, and a disallowed pair gets the window
// term on its logit, so one kernel replaces all four.
//
// What it computes, per (b, h), with s the forward's scaled, masked logits
// (same bias, mask and dropout hash as rel_attention_fwd.cuh), lse and
// delta = rowsum(do * o) from the caller, K the dropout keep factor and
// "real" = (i < L_b) and (j < L_b) (a pair the window disallows has p = 0
// exactly, so it adds nothing to dq, dk, dv or dRel):
//   p = exp(s - lse)  (lse < -1e38 clamped to 3e38, as at :2074)
//   dS = real ? p * (do_i . v_j * K - delta_i) : 0
//   dq_i = scale * (sum_j dS_ij k_j + sum_v dSV[i, v] R_h[v]),
//          dSV[i, v] = sum_{j: id(i, j) = v < V} dS_ij
//   dRel_b[h, v] = scale * sum_i dSV[i, v] q_i      (per example; the
//          caller sums over b, as at :2972)
//   dk_j = scale * sum_i dS_ij q_i,   dv_j = sum_i (real ? p * K : 0) do_i
// Only tiles with real queries and real keys run (the TPU kernels' exact
// pad-tile skip), and with the window only live tiles; dk/dv rows past the
// length come out 0, and dq rows past it receive no add (the caller zeroes
// the buffer).  Offsets as in rel_attention_fwd.cuh: q, do, lse, delta and
// dq hold the global rows [q_start, q_start + S_q), k, v, dk and dv the
// global keys [k_start, k_start + S_k); with a chunk of keys and the global
// lse (the ring schedule) the outputs are that chunk's terms.
//
// Design (grid: 64-key block, head, example; one warpgroup of 128 threads,
// two blocks per SM).  K, V and R_h are copied once into 128-byte-swizzled
// shared memory (64-byte for D = 32) by cp.async; the query tiles (Q, dO,
// lse, delta) stream through a two-stage cp.async ring, the next tile's
// copy in flight while the current one computes.  Per query tile, all
// products on wgmma m64nNk16 (bf16 in, fp32 accumulators), every operand
// read through a shared-memory matrix descriptor in the major order it was
// copied in, so no tile is ever transposed in shared memory:
//   qr = Q . R_h^T, into shared memory for the per-pair bias gather (one
//   small product per tile, not hoisted: Q is resident per tile only);
//   S = Q . K^T and dP = dO . V^T (rows = queries);
//   per element, once per pair: id, bias, masks, exp, dropout hash, P * K
//   and dS.  P * K and dS go to shared memory in bf16; dS also stays in
//   registers as the A operand of dS . K.  The id: a tile whose pairs all
//   have one id (far text tiles, image x text, text x image: most tiles of
//   a long sequence) takes it once and adds its dS row sums to one column
//   of the histogram dSV; elsewhere image pairs look their 2D id up in a
//   (2P - 1)^2 byte table built per block, text pairs take the clipped
//   offset, and dS goes into dSV by native int32 shared atomics in fixed
//   point after merging runs of equal ids along the row;
//   dV += (P K)^T . dO and dK += dS^T . Q (A = the stored tiles read
//   MN-major, B = dO and Q read MN-major);
//   dq_tile = dS . K + dSV . R_h (dSV rounded to bf16), added to the fp32
//   dq buffer by red.global.add.v4.f32;
//   dRel += dSV^T . Q in two bf16 terms, hi = bf16(dSV) and lo = bf16(dSV -
//   hi) (Q is exact in bf16, so the product keeps ~16 bits of dSV, where
//   fp32 FMAs would keep ~1e-5 after their sums), in registers for the
//   block's whole sweep and added once per block to a [B, H, 64, D] fp32
//   buffer by vector reductions (4 key blocks per example at S = 256, so
//   little contention).  The order of the dq and dRel adds varies from run
//   to run, so both are held to bounds, not bit for bit; dk and dv are
//   summed in registers in tile order, deterministically.
//
// Bound (H100 SXM: 989 TFLOP/s dense bf16, 3.35 TB/s): operations
// 10 * sum_b L_b^2 * D * H (q.k^T, do.v^T, ds.k, p^T.do, ds^T.q) +
// 6 * sum_b L_b * V * D * H (q.R^T, dsv.R, dsv^T.q); bytes: q, k, v, do,
// lse and delta read once, dq, dk, dv written once.  At B=32, S=4096, L ~
// U[2048, 4096], H=12, D=64, the L^2 term is ~2.4 TFLOP -> ~2.4 ms, bytes
// ~0.2 ms: bound by operations.  At the pretraining micro-batch (B=64,
// S=256, L ~ U[204, 256]) the operations are ~29 GFLOP (~0.03 ms) and the
// bytes ~0.17 GB (~0.05 ms): bound by bytes.  Windowed (w = 512, g = 198,
// B=8, S=4096), sum_b L_b^2 becomes the allowed real pairs (~40%).
//
// What the earlier design (a dq + dRel pass over key tiles and a dk/dv pass
// over query tiles, on mma.sync) paid and this one removes: (1) at S = 256
// a sweep is 4 tiles, so per-block costs dominated: the dq pass ended with
// dq += dSV . R_h and dRel = dSV^T . Q in scalar fp32 FMAs from shared
// memory and 3136 scalar global atomics per block; here both are tensor-core
// products and dRel is written once per key block in 16-byte reductions.
// (2) s, the id, the gather, the hash and exp were computed in both passes,
// and the dk/dv pass recomputed qr^T behind an extra barrier; here once per
// pair, with the id's divisions hoisted to one per key and one per query
// row.  (3) K^T, Q^T and dO^T were written element by element into shared
// memory; here every operand is read by descriptor.  (4) mma.sync fed from
// padded tiles without an async copy pipeline; here wgmma from swizzled
// tiles behind a cp.async ring.  Shared fp32 atomics are compare-and-swap
// loops on this card (ATOMS.CAST.SPIN in the SASS), hence the fixed point.
// What bounds it now: one warpgroup per block runs its phases in order
// (copies, products, the per-pair pass, reductions), so the tensor cores
// idle while the pair pass runs; overlapping them (warp-specialised
// producer and consumer warpgroups) is the next step.

#include <type_traits>

#include "rel_attention_hopper.cuh"

namespace {

using namespace mmt;

constexpr int LDF = 65;    // fp32 row stride of the [64, 64] qr and dSV tiles

// ------------------------------------------------------------ outputs

// Adds scale * acc (a 64 x N accumulator, rows row0 + [0, 64)) to an fp32
// [rows, N] matrix with row stride `stride`, 16 bytes per reduction: lanes
// t and t ^ 1 swap halves so that each holds 4 adjacent columns of one row.
// Rows >= rows_limit are skipped.
template <int N>
__device__ __forceinline__ void red_rows(float* dst, size_t stride, int row0, int rows_limit,
                                         const float (&acc)[N / 2], float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool odd = t & 1;
  const int r = row0 + (threadIdx.x >> 5) * 16 + g + (odd ? 8 : 0);
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    const float a0 = acc[4 * n], a1 = acc[4 * n + 1], a2 = acc[4 * n + 2], a3 = acc[4 * n + 3];
    const float r0 = __shfl_xor_sync(0xFFFFFFFFu, odd ? a0 : a2, 1);
    const float r1 = __shfl_xor_sync(0xFFFFFFFFu, odd ? a1 : a3, 1);
    if (r >= rows_limit) continue;
    const float4 v = odd ? make_float4(r0, r1, a2, a3) : make_float4(a0, a1, r0, r1);
    float* p = dst + static_cast<size_t>(r) * stride + n * 8 + (t & 2) * 2;
    asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
                 "f"(v.x * scale), "f"(v.y * scale), "f"(v.z * scale), "f"(v.w * scale)
                 : "memory");
  }
}

// Writes scale * acc as bf16 rows row0 + [0, 64) of a [S, H*D] head slice.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, size_t row_stride, int row0, int S,
                                           const float (&acc)[D / 2], float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row0 + (threadIdx.x >> 5) * 16 + g + hr * 8;
    if (r >= S) continue;
    __nv_bfloat16* row = dst + static_cast<size_t>(r) * row_stride + t * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8) =
          pack_bf16(acc[4 * n + 2 * hr] * scale, acc[4 * n + 2 * hr + 1] * scale);
  }
}

// Zeroes rows [r0, r0 + 64) of a [S, H*D] bf16 tensor's head slice.
template <int D>
__device__ __forceinline__ void zero_rows(__nv_bfloat16* dst, int r0, int S, size_t row_stride) {
  for (int idx = threadIdx.x; idx < kT * (D / 8); idx += kThreads) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    if (r0 + r < S)
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r0 + r) * row_stride + c) =
          make_uint4(0u, 0u, 0u, 0u);
  }
}

// ------------------------------------------------------------- kernel

struct BwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;
  const float* delta;
  const __nv_bfloat16* rel;  // [H, 64, D], rows >= V zero; null without bias
  const int* lengths;
  float* dq;                 // [B, S, H, D] fp32, zeroed by the caller
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* drel;               // [B, H, 64, D] fp32, zeroed by the caller
  int Sq, Sk;             // rows of q (do, dq) and of k (v, dk, dv)
  int q_start, k_start;   // global positions of q's row 0 and k's key 0
  int H;
  Geometry geo;
  float scale;
  Dropout dr;
};

// Shared-memory plan (bytes from a 1024-aligned base).  TB = one [64, D]
// bf16 tile; the qr tile (fp32, read by the per-pair pass) shares its bytes
// with the dSV hi / lo tiles (written after it).
template <int D>
struct Smem {
  static constexpr int TB = Swz<D>::kBytes;
  static constexpr int k = 0, v = TB, r = 2 * TB;
  static constexpr int q0 = 3 * TB, q1 = 4 * TB, do0 = 5 * TB, do1 = 6 * TB;
  static constexpr int p = 7 * TB, ds = p + Swz<64>::kBytes;
  static constexpr int hi = ds + Swz<64>::kBytes, lo = hi + Swz<64>::kBytes;
  static constexpr int qr = hi;  // [64][LDF] fp32
  // [64][LDF] dSV: fp32 on a tile with one id, else int32 in units of the
  // row's scale (dsv_unit).
  static constexpr int dsv = hi + 17 * 1024;
  static constexpr int stats = dsv + kT * LDF * 4;  // lse[2][64], delta[2][64]
  static constexpr int kpos = stats + 4 * kT * 4;    // [64] int: jy * W + jx
  static constexpr int dsv_unit = kpos + kT * 4;    // [64] fp32
  static constexpr int ids = dsv_unit + kT * 4;      // [W][W] u8 image ids, W = 2P - 1
  static constexpr int bytes = ids + kMaxImageIds;
  static constexpr int alloc = bytes + 1024;  // slack to align the base
  static_assert(kT * LDF * 4 <= 17 * 1024, "qr tile overruns the dSV tile");
};

template <int D, bool kDropout, bool kWindow>
__global__ void __launch_bounds__(kThreads, 2) rel_attention_bwd_kernel(BwdArgs a) {
  using SD = Swz<D>;
  using S64 = Swz<64>;
  using M = Smem<D>;
  constexpr int NA = D / 2;  // accumulator registers of a 64 x D product
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  float* s_qr = reinterpret_cast<float*>(smem + M::qr);
  float* s_dsv = reinterpret_cast<float*>(smem + M::dsv);
  int* s_dsv_fixed = reinterpret_cast<int*>(smem + M::dsv);
  float* s_dsv_unit = reinterpret_cast<float*>(smem + M::dsv_unit);
  float* s_stats = reinterpret_cast<float*>(smem + M::stats);
  int* s_kpos = reinterpret_cast<int*>(smem + M::kpos);
  const uint8_t* s_ids = smem + M::ids;

  // k0: the block's first key, local; gk0: global.  Query tiles are global.
  const int k0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int gk0 = a.k_start + k0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int Sq = a.Sq, Sk = a.Sk, H = a.H;
  const Geometry& geo = a.geo;
  const int L = max(0, a.lengths[b]);
  // Ends of the real rows of q and of the real keys of k (global).
  const int Lq = min(L, a.q_start + Sq), Lk = min(L, a.k_start + Sk);
  const size_t row_stride = static_cast<size_t>(H) * D;
  const size_t head_q = static_cast<size_t>(b) * Sq * row_stride + static_cast<size_t>(h) * D;
  const size_t head_k = static_cast<size_t>(b) * Sk * row_stride + static_cast<size_t>(h) * D;
  const size_t stat0 = (static_cast<size_t>(b) * H + h) * Sq;

  const bool has_rel = a.rel != nullptr && geo.vocab > 0;
  const LiveTiles live = live_tiles<kWindow>(gk0, Lq, geo, a.q_start / kT);
  const int n_tiles = live.count();
  // Padded keys, or no live query tile in q: dk = dv = 0, no dq or dRel.
  if (gk0 >= Lk || n_tiles == 0) {
    zero_rows<D>(a.dk + head_k, k0, Sk, row_stride);
    zero_rows<D>(a.dv + head_k, k0, Sk, row_stride);
    return;
  }

  // One query tile's stage: Q, dO, lse, delta (gq0: the tile's global row).
  auto load_stage = [&](int stage, int gq0) {
    const int q0 = gq0 - a.q_start;
    const size_t off = head_q + static_cast<size_t>(q0) * row_stride;
    copy_tile<D>(base + (stage ? M::q1 : M::q0), a.q + off, Sq - q0, row_stride);
    copy_tile<D>(base + (stage ? M::do1 : M::do0), a.dout + off, Sq - q0, row_stride);
    const int r = tid & (kT - 1), i = q0 + r;
    const float* src = (tid < kT ? a.lse : a.delta) + stat0;
    cp_async4(base + M::stats + ((tid < kT ? 0 : 2) + stage) * kT * 4 + r * 4,
              i < Sq ? src + i : src, i < Sq);
  };

  copy_tile<D>(base + M::k, a.k + head_k + static_cast<size_t>(k0) * row_stride, Sk - k0,
               row_stride);
  copy_tile<D>(base + M::v, a.v + head_k + static_cast<size_t>(k0) * row_stride, Sk - k0,
               row_stride);
  if (has_rel) copy_tile<D>(base + M::r, a.rel + static_cast<size_t>(h) * kT * D, kT, D);
  load_stage(0, live.tile(0) * kT);
  cp_async_commit();
  for (int idx = tid; idx < kT * LDF; idx += kThreads) s_dsv[idx] = 0.f;
  // Image pairs look their id up: table[(dy + P - 1) * W + dx + P - 1],
  // the index split as key code jy * W + jx minus a per-row query code.
  const int P = max(geo.patch_per_row, 1), W = 2 * P - 1;
  if (tid < kT) {
    const int j = gk0 + tid, jy = j / P;
    s_kpos[tid] = jy * W + (j - jy * P);
  }
  if (has_rel && geo.image_len > 0)
    for (int idx = tid; idx < W * W; idx += kThreads)
      smem[M::ids + idx] = static_cast<uint8_t>(
          min(image_id(idx / W - (P - 1), idx % W - (P - 1), geo.core_layers), kVP));

  const uint32_t seed_b = kDropout ? example_seed(a.dr, b) : 0u;
  const int r_lo = warp * 16 + g;  // this lane's rows of a 64-row product: r_lo, r_lo + 8

  float dk_acc[NA], dv_acc[NA], drel_acc[NA];
  zero(dk_acc);
  zero(dv_acc);
  zero(drel_acc);

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = live.tile(it) * kT, st = it & 1;
    if (it + 1 < n_tiles) load_stage(st ^ 1, live.tile(it + 1) * kT);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's stage (and K, V, R_h) has landed
    fence_async_proxy();
    __syncthreads();
    const uint32_t sq = base + (st ? M::q1 : M::q0), sdo = base + (st ? M::do1 : M::do0);

    float acc[32], dp[32];
    if (has_rel) {  // qr = Q . R_h^T; each warp reads back only its own rows
      zero(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<0, 0>(acc, SD::k_major(sq, kk), SD::k_major(base + M::r, kk));
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = n * 8 + t * 2;
        s_qr[r_lo * LDF + c] = acc[4 * n];
        s_qr[r_lo * LDF + c + 1] = acc[4 * n + 1];
        s_qr[(r_lo + 8) * LDF + c] = acc[4 * n + 2];
        s_qr[(r_lo + 8) * LDF + c + 1] = acc[4 * n + 3];
      }
    }
    zero(acc);
    zero(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<0, 0>(acc, SD::k_major(sq, kk), SD::k_major(base + M::k, kk));    // S = Q K^T
      wgmma_ss<0, 0>(dp, SD::k_major(sdo, kk), SD::k_major(base + M::v, kk));    // dO V^T
    }
    wg_commit();
    wg_wait_all();
    __syncwarp();

    float lse_r[2], delta_r[2];
    int qcode[2];
    uint32_t hrow[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int i = q0 + r_lo + hr * 8, iy = i / P;
      const float l = s_stats[st * kT + r_lo + hr * 8];
      lse_r[hr] = l < -1e38f ? 3e38f : l;
      delta_r[hr] = s_stats[(2 + st) * kT + r_lo + hr * 8];
      qcode[hr] = iy * W + (i - iy * P) - (P - 1) * (W + 1);
      hrow[hr] = hash_row(seed_b, h, i);
    }
    const int tile_id = has_rel ? uniform_tile_id(q0, gk0, geo) : kVP;

    // Once per pair, with no branch between elements: logit, p, dropout,
    // dS; P K and dS to shared memory (bf16, rows = queries), dS also as
    // the A fragments of dS . K; then the id histogram dSV.  A tile with
    // one id adds its bias per row and its dS row sums to one column of
    // dSV.  The others take each pair's id (clamped to kVP = no bin) and add
    // dS into dSV in fixed point: shared fp32 atomics are compare-and-swap
    // loops on this card, int32 ones are native.  Each row's unit is a power
    // of two, 2^-21 of a bound on its largest |dS| (64 adds stay below
    // 2^27; each value rounds by at most 2^-21 of the row's largest |dS|,
    // below the bf16 hi + lo split of the product); runs of equal ids along
    // the row (j ascending) are merged first, and the integer sums are
    // exact.
    uint32_t ds_a[4][4], id_bytes[8];
    auto pair_pass = [&](auto uniform_tag) {
      constexpr bool kUniform = decltype(uniform_tag)::value;
      float bias_r[2] = {0.f, 0.f};
      if (kUniform && tile_id < geo.vocab) {
        bias_r[0] = s_qr[r_lo * LDF + tile_id];
        bias_r[1] = s_qr[(r_lo + 8) * LDF + tile_id];
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float pk[4];
        uint32_t ids = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1;
          const int rr = r_lo + hr * 8;
          const int i = q0 + rr;
          const int c = n * 8 + t * 2 + (e & 1);
          const int j = gk0 + c;
          float x = acc[4 * n + e];
          if constexpr (kUniform) {
            x += bias_r[hr];
          } else {
            const int il = geo.image_len;
            const int id = min(
                i < il ? (j < il ? s_ids[s_kpos[c] - qcode[hr]] : geo.text_part_id)
                       : (j < il ? geo.image_part_id : band_id(j - i, geo.text_max_distance)),
                kVP);
            if (id < geo.vocab) x += s_qr[rr * LDF + id];
            ids |= static_cast<uint32_t>(id) << (8 * e);
          }
          x *= a.scale;
          if ((i < Lq) != (j < Lk)) x += kMaskBias;
          if (kWindow && !window_allowed(i, j, geo)) x += kMaskBias;
          const float p = __expf(x - lse_r[hr]);
          float keep = 1.f;
          if constexpr (kDropout) keep = keep_of(a.dr, hrow[hr], j);
          const bool real = i < Lq && j < Lk;
          // dp * keep rounded on its own (no FMA with delta), so that the
          // dense and windowed instantiations give the same dS bit for bit.
          const float ds = real ? p * (__fmul_rn(dp[4 * n + e], keep) - delta_r[hr]) : 0.f;
          pk[e] = real ? p * keep : 0.f;
          acc[4 * n + e] = ds;
        }
        id_bytes[n] = ids;
        const int c = n * 8 + t * 2;
        const uint32_t ds_lo = pack_bf16(acc[4 * n], acc[4 * n + 1]);
        const uint32_t ds_hi = pack_bf16(acc[4 * n + 2], acc[4 * n + 3]);
        ds_a[n >> 1][(n & 1) * 2] = ds_lo;
        ds_a[n >> 1][(n & 1) * 2 + 1] = ds_hi;
        *reinterpret_cast<uint32_t*>(smem + M::ds + S64::elem(r_lo, c)) = ds_lo;
        *reinterpret_cast<uint32_t*>(smem + M::ds + S64::elem(r_lo + 8, c)) = ds_hi;
        *reinterpret_cast<uint32_t*>(smem + M::p + S64::elem(r_lo, c)) = pack_bf16(pk[0], pk[1]);
        *reinterpret_cast<uint32_t*>(smem + M::p + S64::elem(r_lo + 8, c)) =
            pack_bf16(pk[2], pk[3]);
      }
      if constexpr (!kUniform) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float m = 0.f;
#pragma unroll
          for (int n = 0; n < 8; ++n)
            m = fmaxf(m, fmaxf(fabsf(acc[4 * n + 2 * hr]), fabsf(acc[4 * n + 2 * hr + 1])));
          m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, 1));
          m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, 2));
          int e;
          frexpf(m, &e);  // m < 2^e
          const float scale = ldexpf(1.f, 21 - e);
          if (t == 0) s_dsv_unit[r_lo + hr * 8] = ldexpf(1.f, e - 21);
          int* row = s_dsv_fixed + (r_lo + hr * 8) * LDF;
          int run_id = kVP, run_sum = 0;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
#pragma unroll
            for (int e2 = 2 * hr; e2 < 2 * hr + 2; ++e2) {
              const int id = (id_bytes[n] >> (8 * e2)) & 0xFF;
              if (id != run_id) {
                if (run_id < geo.vocab) atomicAdd(row + run_id, run_sum);
                run_id = id;
                run_sum = 0;
              }
              run_sum += __float2int_rn(acc[4 * n + e2] * scale);
            }
          }
          if (run_id < geo.vocab) atomicAdd(row + run_id, run_sum);
        }
      }
      if constexpr (kUniform) {  // one column of dSV: the row sums, one lane adds each
        if (tile_id < geo.vocab) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            float sum = 0.f;
#pragma unroll
            for (int n = 0; n < 8; ++n) sum += acc[4 * n + 2 * hr] + acc[4 * n + 2 * hr + 1];
            sum += __shfl_xor_sync(0xFFFFFFFFu, sum, 1);
            sum += __shfl_xor_sync(0xFFFFFFFFu, sum, 2);
            if (t == 0) s_dsv[(r_lo + hr * 8) * LDF + tile_id] += sum;
          }
        }
      }
    };
    if (tile_id >= 0)
      pair_pass(std::true_type{});
    else
      pair_pass(std::false_type{});
    fence_async_proxy();
    __syncthreads();  // every row of P K, dS and dSV is in place; qr is read

    // dV += (P K)^T . dO and dK += dS^T . Q: K = the 64 queries.
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < kT / 16; ++kc) {
      wgmma_ss<1, 1>(dv_acc, S64::mn_major(base + M::p, kc), SD::mn_major(sdo, kc));
      wgmma_ss<1, 1>(dk_acc, S64::mn_major(base + M::ds, kc), SD::mn_major(sq, kc));
    }
    wg_commit();

    if (has_rel) {  // dSV -> bf16 hi + lo tiles (over the qr tile); zero it for the next tile
      for (int idx = tid; idx < kT * (kT / 2); idx += kThreads) {
        const int r = idx / (kT / 2), c = (idx % (kT / 2)) * 2;
        float* src = s_dsv + r * LDF + c;
        float x0 = src[0], x1 = src[1];
        if (tile_id < 0) {
          const float unit = s_dsv_unit[r];
          x0 = static_cast<float>(__float_as_int(x0)) * unit;
          x1 = static_cast<float>(__float_as_int(x1)) * unit;
        }
        src[0] = src[1] = 0.f;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        const uint32_t lo = pack_bf16(x0 - __low2float(hi), x1 - __high2float(hi));
        *reinterpret_cast<__nv_bfloat162*>(smem + M::hi + S64::elem(r, c)) = hi;
        *reinterpret_cast<uint32_t*>(smem + M::lo + S64::elem(r, c)) = lo;
      }
      fence_async_proxy();
      __syncthreads();
    }

    // dq_tile = dS . K + dSV . R_h; dRel += dSV^T . Q (hi and lo terms).
    float dq_acc[NA];
    zero(dq_acc);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < kT / 16; ++kc)
      wgmma_rs<1>(dq_acc, ds_a[kc], SD::mn_major(base + M::k, kc));
    if (has_rel) {
#pragma unroll
      for (int kc = 0; kc < kT / 16; ++kc) {
        wgmma_ss<0, 1>(dq_acc, S64::k_major(base + M::hi, kc), SD::mn_major(base + M::r, kc));
        wgmma_ss<1, 1>(drel_acc, S64::mn_major(base + M::hi, kc), SD::mn_major(sq, kc));
        wgmma_ss<1, 1>(drel_acc, S64::mn_major(base + M::lo, kc), SD::mn_major(sq, kc));
      }
    }
    wg_commit();
    wg_wait_all();  // and the dV / dK products
    red_rows<D>(a.dq + head_q, row_stride, q0 - a.q_start, Lq - a.q_start, dq_acc, a.scale);
    __syncthreads();  // this stage, P K, dS, hi / lo are free for the next tile
  }

  store_rows<D>(a.dk + head_k, row_stride, k0, Sk, dk_acc, a.scale);
  store_rows<D>(a.dv + head_k, row_stride, k0, Sk, dv_acc, 1.f);
  if (has_rel)  // rows v >= V are 0: dSV has no such column
    red_rows<D>(a.drel + (static_cast<size_t>(b) * H + h) * kT * D, D, 0, geo.vocab, drel_acc,
                a.scale);
}

template <int D, bool kDropout, bool kWindow>
cudaError_t launch(dim3 grid, cudaStream_t s, const BwdArgs& a) {
  auto kernel = rel_attention_bwd_kernel<D, kDropout, kWindow>;
  constexpr int smem = Smem<D>::alloc;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

using LaunchFn = decltype(&launch<64, false, false>);

template <int D>
LaunchFn pick(bool drop, bool window) {
  if (drop) return window ? launch<D, true, true> : launch<D, true, false>;
  return window ? launch<D, false, true> : launch<D, false, false>;
}

}  // namespace

// q, do: bf16 [B, S_q, H, D], k, v, dk, dv: bf16 [B, S_k, H, D], contiguous;
// dq: fp32 [B, S_q, H, D], zeroed by the caller (rows past the length stay
// 0); lse, delta: fp32 [B, H, S_q]; rel: bf16 [H, 64, D] (rows >= V zero) or
// null; lengths: int32 [B] (global); drel: fp32 [B, H, 64, D], zeroed by the
// caller (null without rel).  Offsets, window and dropout arguments as in
// mmt_rel_attention_fwd.  Launches one
// kernel on `stream`, allocates nothing and returns the CUDA error code.
extern "C" int mmt_rel_attention_bwd(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     const void* rel, const void* lengths, void* dq, void* dk,
                                     void* dv, void* drel, int batch, int seq_q, int seq_k,
                                     int q_start, int k_start, int num_heads, int head_dim,
                                     int vocab, int image_len,
                                     int patch_per_row, int core_layers, int text_max_distance,
                                     int image_part_id, int text_part_id, int window,
                                     int num_global, float scale, int dropout_threshold,
                                     float keep_scale, int seed, int batch_start, void* stream) {
  if (vocab < 0 || vocab > kVP || dropout_threshold < 0 || dropout_threshold > (1 << 24) ||
      window < 0 || (window > 0 && num_global <= 0) || q_start < 0 || k_start < 0 ||
      q_start % kT || k_start % kT || seq_q <= 0 || seq_k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rel != nullptr && vocab > 0 && drel == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (image_len > 0 && patch_per_row > kMaxPatchPerRow)
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
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.drel = static_cast<float*>(drel);
  a.Sq = seq_q;
  a.Sk = seq_k;
  a.q_start = q_start;
  a.k_start = k_start;
  a.H = num_heads;
  // The same pattern; keeps r0 + w from overflowing.
  window = min(window, max(q_start + seq_q, k_start + seq_k));
  a.geo = Geometry{image_len,     patch_per_row, core_layers,     text_max_distance,
                   image_part_id, text_part_id,  rel ? vocab : 0, window,
                   num_global};
  a.scale = scale;
  a.dr = Dropout{static_cast<uint32_t>(dropout_threshold), keep_scale,
                 static_cast<uint32_t>(seed), static_cast<uint32_t>(batch_start)};
  const dim3 grid((seq_k + kT - 1) / kT, num_heads, batch);
  const bool drop = dropout_threshold > 0;
  LaunchFn fn;
  if (head_dim == 64) {
    fn = pick<64>(drop, window > 0);
  } else if (head_dim == 32) {
    fn = pick<32>(drop, window > 0);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(fn(grid, static_cast<cudaStream_t>(stream), a));
}

extern "C" const char* mmt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
