// Relative-bias flash attention forward for Hopper (sm_90a).
//
// Replaces the two TPU forward kernels of mmt_tpu/ops/pallas_attention.py:
//   K1 `_fwd_kernel` (rect grid, `_attention_forward`) and
//   K2 `_fwd_list_kernel` (list grid, `_run_fwd_list`), in both of its
//   uses: the far/structured split schedule `_forward_split` (with the
//   image-corner build `_build_img_corner` and the logsumexp combine of the
//   split) and the sliding-window live-tile list `_window_tile_list`
//   (`_attention_forward` :1891-1919).  Both lists are TPU schedules, not
//   semantics: one pass here computes the function they compute, and the
//   split's far/structured distinction becomes a per-tile branch.
//
// What it computes, for each (batch b, head h) and query row i < S:
//   s[i, j] = (q_i . k_j + bias(i, j)) * scale          (fp32)
//   bias(i, j) = qr[i, id(i, j)] if id < V else 0,   qr = q_tile . R_h^T
//   s[i, j] += -10000 where (i < L_b) != (j < L_b)
//   s[i, j] += -10000 where the window disallows (i, j)   (window > 0)
//   o_i = softmax_j(s[i, :]) . v   (p rounded to bf16 before p.v, as the
//   TPU kernel does), lse_i = log sum_j exp(s[i, j]) (natural log: the
//   backward reads p = exp(s - lse)).
// Attention dropout (K1's in-kernel dropout, pallas_attention.py:1740-1751)
// multiplies p in fp32 by the keep factor of the hash (keep_of in
// rel_attention_hopper.cuh) after p has entered the row sum l and before
// the bf16 rounding for p.v, so lse is unchanged by dropout.  The dropout is
// a template argument: at rate 0 the kernel is the one without dropout.
// Only key tiles with k0 < L_b run (the TPU kernel's exact pad-tile skip);
// a query tile with q0 >= L_b writes o = 0 and lse = -inf.
// Offsets (the sequence-sharded schedules, pallas_attention.py's `qoff`):
// q holds the global rows [q_start, q_start + S_q) and k, v the global keys
// [k_start, k_start + S_k), S_q != S_k allowed, both starts multiples of
// 64; every position the kernel derives (ids, image codes, the length and
// window terms, the dropout hash) is global, the lengths are global, keys
// past the chunk count as padding, and the dropout's example index is
// batch_start + b.  A real row with no live key in the chunk (no live tile,
// or only pairs carrying a -10000 term: its largest base-2 logit below
// kEmptyRow2) writes o = 0 and lse = -inf, so that a logsumexp combine over
// chunks ignores it.  The window is a
// template argument too: the windowed variant visits only the block's live
// key tiles (LiveTiles in rel_attention_common.cuh, the block's own
// `_window_tile_contributes`; no static list) and adds the window term; at
// window 0 the kernel is the dense one.  id(i, j) is the closed form of
// mmt_tpu_torch/features/relative_position.py: 2D patch ids for i, j < P^2,
// the part ids for image x text pairs, and the clipped 1D id of j - i for
// text x text pairs.
//
// Bound at the flagship shape (B=32, S=4096, H=12, D=64, V=49, L ~ U[2048,
// 4096]): FLOPs 4 * sum_b L_b^2 * D * H + 2 * sum_b L_b * V * D * H, about
// 0.95 TFLOP per layer, over 989 TFLOP/s = ~1.0 ms; the bytes of q, k, v and
// o are 4 * B * S * H * D * 2 = 0.4 GB over 3.35 TB/s = ~0.12 ms.  So the
// kernel is bound by operations.  Windowed (w = 512, g = 198, the 4k
// pretraining micro-batch B=8), L_b^2 becomes the allowed real pairs, about
// 40% of them: ~0.1 TFLOP, ~0.1 ms, still above the ~0.03 ms of bytes.  At
// the pretraining micro-batch (B=64, S=256, L ~ U[204, 256]) a block sweeps
// at most 4 key tiles: ~15 GFLOP (~0.015 ms) against ~0.1 GB (~0.03 ms), so
// bound by bytes, and the block's set-up (Q, R_h, qr, the id tables) is a
// large share of its work.
//
// Design (grid: 128-query block, head, example; two warpgroups of 128
// threads, each owning 64 query rows; two blocks per SM).  Every product
// runs on wgmma m64nNk16 (bf16 in, fp32 accumulators), every operand read
// through a shared-memory matrix descriptor from a 128-byte-swizzled tile
// (64-byte for D = 32) in the major order it was copied in:
//   Q and R_h are copied once by cp.async; qr = Q . R_h^T is one product
//   per warpgroup, kept in shared memory pre-multiplied by scale * log2(e);
//   K and V tiles of 64 keys stream through a two-stage ring filled by TMA
//   (one thread issues both boxes of a tile; rows past S arrive as 0) and
//   guarded by mbarriers: a stage is refilled once every warp of both
//   warpgroups has released it, so the next tile's copy is in flight while
//   the current one computes and the two warpgroups need not keep in step
//   (each computes only its own live tiles of the block's union);
//   S = Q . K^T (both K-major); O += P . V with P from registers (the S
//   accumulators turned into bf16 A fragments, no shared-memory round
//   trip) and V read MN-major, so no tile is ever transposed.
// The logit of a pair is one FMA, s2 = acc * scale * log2(e) + bias2, in
// base 2 (exp2 on the accumulators; lse goes back to natural log at the
// end).  The bias is decided once per tile: a tile whose pairs all share
// one id (uniform_tile_id: far text tiles, image x text, text x image; 79%
// of the live tiles at the flagship) takes a per-row constant, or nothing
// when the id is out of vocabulary (the flagship's part ids 229 / 230).
// The other tiles take each pair's id with no division and no vocabulary
// test, in one of three forms: the image corner looks it up in a (2P - 1)^2
// byte table by a per-key code minus a per-row code, the text band takes
// the clipped offset, and tiles across the image's edge choose between the
// two and the part ids per pair.  The length term runs only on tiles that
// hold the length, the window term only on tiles the band edge cuts (tiles
// wholly inside the band or the global prefix skip it), and the dropout
// hash is hoisted per row (hash_row).  The products that decide
// bit-identity are written out: s2 by __fmaf_rn and l by __fmaf_rn, so
// that the dense and windowed instantiations (at window >= S: the same
// tiles, in the same order, with no window term) and the instantiations
// with and without dropout (the same l) cannot be contracted differently.
//
// Each step of this design was timed against the one before it in one
// call (probes/fwd_ab.py; PERF.md has the numbers): one warpgroup on wgmma
// with a cp.async ring, two warpgroups sharing each K / V tile, the
// per-pair ids by tile kind, the TMA ring.  Folding the max offset into the
// logit FMA, and issuing each tile's P . V with the next tile's Q . K^T
// over a three-stage ring, were no faster and were not kept.
//
// What bounds it now: about 300 TFLOP/s at the flagship, a third of the
// tensor-core peak.  Each warpgroup still runs its phases in order (S
// product, logits and softmax, P . V product), and at D = 64 the
// exponentials of a tile (4096 on 16 MUFU lanes per SM) take as long as its
// two products, so the tensor cores idle unless another warpgroup's
// products fill the gap; the 128-register cap of two 256-thread blocks per
// SM leaves no room for a second S accumulator.  FA3's producer warp with
// setmaxnreg and two consumer warpgroups in ping-pong is the next step.  At
// S = 256 every tile of a sequence meets the 196-slot image corner, so the
// per-pair path (two shared-memory loads per pair) and the block's set-up
// dominate, and the kernel is slower than SDPA handed the bias as a mask.

#include <cuda.h>  // CUtensorMap (the encoder is looked up at run time: no libcuda link)

#include "rel_attention_hopper.cuh"

namespace {

using namespace mmt;

constexpr int LDF = 65;  // fp32 row stride of the [64, 64] qr tile
constexpr int kMaxImageLen = kMaxPatchPerRow * kMaxPatchPerRow;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWG = 2;  // warpgroups per block, 64 query rows each
constexpr int kBlockThreads = kWG * kThreads;
constexpr int kBlockRows = kWG * kT;
constexpr int kStages = 2;  // K / V tiles in the TMA ring
// A row whose largest base-2 logit is below this has only pairs with a
// -10000 term: no live key.
constexpr float kEmptyRow2 = 0.5f * kMaskBias * kLog2e;

// ------------------------------------------------------ TMA and mbarrier

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Waits for the barrier's phase with this parity to complete.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// One [64, D] box of a [B, S, H * D] tensor at (column c0, row c1, example
// c2) into shared memory; its bytes complete a transaction on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

struct FwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* rel;  // [H, 64, D], rows >= V zero; null without bias
  const int* lengths;
  __nv_bfloat16* o;
  float* lse;
  int Sq, Sk;             // rows of q and of k / v
  int q_start, k_start;   // global positions of q's row 0 and k's key 0
  int H;
  Geometry geo;
  float scale;
  Dropout dr;
};

// Shared-memory plan (bytes from a 1024-aligned base).  TB = one [64, D]
// bf16 tile.
template <int D>
struct Smem {
  static constexpr int TB = Swz<D>::kBytes;
  __host__ __device__ static constexpr int q(int wg) { return wg * TB; }
  static constexpr int r = kWG * TB;
  __host__ __device__ static constexpr int k(int stage) { return (kWG + 1 + 2 * stage) * TB; }
  __host__ __device__ static constexpr int v(int stage) { return (kWG + 2 + 2 * stage) * TB; }
  static constexpr int qr = (kWG + 1 + 2 * kStages) * TB;  // [kWG][64][LDF] fp32, x scale log2(e)
  static constexpr int kpos = qr + kWG * kT * LDF * 4;     // [P^2] int16: jy * W + jx
  static constexpr int ids = kpos + kMaxImageLen * 2;     // [W][W] u8 image ids, W = 2P - 1
  // mbarriers: full[s] (the stage's TMA landed), empty[s] (every warp is
  // done with it).
  static constexpr int full = (ids + kMaxImageIds + 7) / 8 * 8;
  static constexpr int empty = full + 8 * kStages;
  static constexpr int bytes = empty + 8 * kStages;
  static constexpr int alloc = bytes + 1024;  // slack to align the base
};

// Whether the window term can change a pair of the tile [q0, q0 + 64) x
// [k0, k0 + 64) below S: not when every row or every key is global, nor
// when the tile lies wholly inside the band |i - j| <= window (at window
// >= S no tile is cut, so the windowed kernel then does the dense one's
// arithmetic).
// Global positions; q_end / k_end are the chunks' ends.
__device__ __forceinline__ bool window_cuts(int q0, int k0, int q_end, int k_end,
                                           const Geometry& g) {
  if (q0 + kT <= g.num_global || k0 + kT <= g.num_global) return false;
  return min(k0 + kT, k_end) - 1 - q0 > g.window || min(q0 + kT, q_end) - 1 - k0 > g.window;
}

// Whether `tile` is one of a LiveTiles sweep's tiles.
__device__ __forceinline__ bool holds(const LiveTiles& live, int tile) {
  return (tile >= live.first && tile < live.head) ||
         (tile >= live.band_lo && tile < live.band_hi);
}

template <int D, bool kDropout, bool kWindow>
__global__ void __launch_bounds__(kBlockThreads, 2)
    rel_attention_fwd_kernel(const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v, FwdArgs a) {
  using SD = Swz<D>;
  using M = Smem<D>;
  constexpr int NA = D / 2;  // accumulator registers of a 64 x D product
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  int16_t* s_kpos = reinterpret_cast<int16_t*>(smem + M::kpos);
  const uint8_t* s_ids = smem + M::ids;

  const int tid = threadIdx.x, wg = tid / kThreads, warp = (tid / 32) % 4, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // Local rows b0, q0 of q; global rows gb0, gq0 (positions, ids, masks).
  const int b0 = blockIdx.x * kBlockRows, h = blockIdx.y, b = blockIdx.z;
  const int q0 = b0 + wg * kT;  // this warpgroup's 64 rows
  const int gb0 = a.q_start + b0, gq0 = a.q_start + q0;
  float* s_qr = reinterpret_cast<float*>(smem + M::qr) + wg * kT * LDF;
  const int Sq = a.Sq, H = a.H;
  const Geometry& geo = a.geo;
  const int L = max(0, a.lengths[b]);
  // Ends of the real rows of q and of the real keys of k (global).
  const int Lq = min(L, a.q_start + Sq), Lk = min(L, a.k_start + a.Sk);
  const size_t row_stride = static_cast<size_t>(H) * D;
  const size_t head0 = static_cast<size_t>(b) * Sq * row_stride + static_cast<size_t>(h) * D;
  float* lse_bh = a.lse + (static_cast<size_t>(b) * H + h) * Sq;

  const bool active = gq0 < Lq;
  if (!active) {  // every key tile is skipped: o = 0, lse = -inf
    for (int idx = tid % kThreads; idx < kT * (D / 8); idx += kThreads) {
      const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
      if (q0 + r < Sq)
        *reinterpret_cast<uint4*>(a.o + head0 + static_cast<size_t>(q0 + r) * row_stride + c) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    for (int r = tid % kThreads; r < kT; r += kThreads)
      if (q0 + r < Sq) lse_bh[q0 + r] = -INFINITY;
  }
  if (gb0 >= Lq) return;  // the whole block is past the length

  const bool has_rel = a.rel != nullptr && geo.vocab > 0;
  // The block's key tiles: the union of its warpgroups' live tiles (one
  // head, one band); each warpgroup computes only its own.
  const int first = a.k_start / kT;
  const LiveTiles mine = live_tiles<kWindow>(gq0, Lk, geo, first);
  LiveTiles live = live_tiles<kWindow>(gb0, Lk, geo, first);
  if (gb0 + kBlockRows - kT < Lq)
    live.band_hi =
        max(live.band_hi, live_tiles<kWindow>(gb0 + kBlockRows - kT, Lk, geo, first).band_hi);
  const int n_tiles = live.count();
  // The K / V ring: thread 0 fills a stage by TMA (rows past S read as 0)
  // once every warp has released it; each warp waits for the stage's
  // copy, uses it, and releases it, so the two warpgroups need not keep in
  // step.
  const uint32_t full = base + M::full, empty = base + M::empty;
  auto load_kv = [&](int stage, int k0) {  // k0: global
    mbar_expect_tx(full + 8 * stage, 2 * M::TB);
    tma_load(base + M::k(stage), &tm_k, full + 8 * stage, h * D, k0 - a.k_start, b);
    tma_load(base + M::v(stage), &tm_v, full + 8 * stage, h * D, k0 - a.k_start, b);
  };
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 4 * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int it = 0; it < min(kStages - 1, n_tiles); ++it) load_kv(it, live.tile(it) * kT);
#pragma unroll
  for (int w = 0; w < kWG; ++w)
    copy_tile<D, kBlockThreads>(base + M::q(w),
                                a.q + head0 + static_cast<size_t>(b0 + w * kT) * row_stride,
                                Sq - b0 - w * kT, row_stride);
  if (has_rel)
    copy_tile<D, kBlockThreads>(base + M::r, a.rel + static_cast<size_t>(h) * kT * D, kT, D);
  cp_async_commit();

  // Image pairs look their id up: table[(dy + P - 1) * W + dx + P - 1], the
  // index split as key code jy * W + jx minus a per-row query code.  Only a
  // block with image rows reads the tables.
  const int il = has_rel ? geo.image_len : 0;
  const int P = max(geo.patch_per_row, 1), W = 2 * P - 1;
  if (gb0 < il) {
    for (int j = tid; j < il; j += kBlockThreads) {
      const int jy = j / P;
      s_kpos[j] = static_cast<int16_t>(jy * W + (j - jy * P));
    }
    for (int idx = tid; idx < W * W; idx += kBlockThreads)
      smem[M::ids + idx] = static_cast<uint8_t>(
          min(image_id(idx / W - (P - 1), idx % W - (P - 1), geo.core_layers), kVP));
  }

  const float c2 = a.scale * kLog2e;       // logits in base 2
  const float mask2 = kMaskBias * kLog2e;  // the -10000 terms, in base 2
  const uint32_t seed_b = kDropout ? example_seed(a.dr, b) : 0u;
  const int r_lo = warp * 16 + g;  // this lane's rows of a 64-row product: r_lo, r_lo + 8
  int qcode[2];
  uint32_t hrow[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i = gq0 + r_lo + hr * 8, iy = i / P;
    qcode[hr] = iy * W + (i - iy * P) - (P - 1) * (W + 1);
    hrow[hr] = hash_row(seed_b, h, i);
  }

  cp_async_wait<0>();
  fence_async_proxy();
  __syncthreads();  // Q, R_h and the id tables are in place
  if (has_rel && active) {  // qr = Q . R_h^T; each warp reads back only its own rows
    float acc[32];
    zero(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0, 0>(acc, SD::k_major(base + M::q(wg), kk), SD::k_major(base + M::r, kk));
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = n * 8 + t * 2;
      s_qr[r_lo * LDF + c] = acc[4 * n] * c2;
      s_qr[r_lo * LDF + c + 1] = acc[4 * n + 1] * c2;
      s_qr[(r_lo + 8) * LDF + c] = acc[4 * n + 2] * c2;
      s_qr[(r_lo + 8) * LDF + c + 1] = acc[4 * n + 3] * c2;
    }
    if (t == 0) s_qr[r_lo * LDF + kVP] = s_qr[(r_lo + 8) * LDF + kVP] = 0.f;
    __syncwarp();
  }

  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this lane's part of the row sums
  float o_acc[NA];
  zero(o_acc);

  for (int it = 0; it < n_tiles; ++it) {
    const int tile = live.tile(it), k0 = tile * kT, st = it % kStages;
    if (tid == 0 && it + kStages - 1 < n_tiles) {  // refill the stage tile it - 1 used
      const int next = it + kStages - 1, sn = next % kStages;
      if (next >= kStages) mbar_wait(empty + 8 * sn, (next / kStages - 1) & 1);
      load_kv(sn, live.tile(next) * kT);
    }
    __syncwarp();
    mbar_wait(full + 8 * st, (it / kStages) & 1);  // this tile's K and V have landed
    if (active && holds(mine, tile)) {
      float s[32];
      zero(s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<0, 0>(s, SD::k_major(base + M::q(wg), kk), SD::k_major(base + M::k(st), kk));
      wg_commit();
      wg_wait_all();

      // Logits in base 2: one FMA per pair, the bias decided once per tile.
      const int tile_id = has_rel ? uniform_tile_id(gq0, k0, geo) : kVP;
      if (tile_id >= 0) {
        float bias[2] = {0.f, 0.f};
        if (tile_id < geo.vocab) {
          bias[0] = s_qr[r_lo * LDF + tile_id];
          bias[1] = s_qr[(r_lo + 8) * LDF + tile_id];
        }
#pragma unroll
        for (int e = 0; e < 32; ++e) s[e] = __fmaf_rn(s[e], c2, bias[(e >> 1) & 1]);
      } else {
        // Each pair's id, clamped to kVP: qr's columns V..63 are 0 (R_h's rows
        // there are), and so is its padding column kVP, so an id out of
        // vocabulary reads a zero bias without a test.
        auto add_bias = [&](auto id_of) {
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int rr = r_lo + ((e >> 1) & 1) * 8;
            s[e] = __fmaf_rn(s[e], c2, s_qr[rr * LDF + id_of(e)]);
          }
        };
        auto row_of = [&](int e) { return gq0 + r_lo + ((e >> 1) & 1) * 8; };
        auto col_of = [&](int e) { return k0 + (e >> 2) * 8 + t * 2 + (e & 1); };
        int kp[16];  // key codes of this lane's 16 columns (image keys only)
        if (k0 < il) {
#pragma unroll
          for (int c = 0; c < 16; ++c) {
            const int j = k0 + (c >> 1) * 8 + t * 2 + (c & 1);
            kp[c] = j < il ? s_kpos[j] : 0;
          }
        }
        auto image = [&](int e) { return s_ids[kp[(e >> 2) * 2 + (e & 1)] - qcode[(e >> 1) & 1]]; };
        auto band = [&](int e) {
          return min(band_id(col_of(e) - row_of(e), geo.text_max_distance), kVP);
        };
        if (gq0 + kT <= il && k0 + kT <= il) {  // the image corner
          add_bias(image);
        } else if (gq0 >= il && k0 >= il) {  // the text band
          add_bias(band);
        } else {  // a tile across the image's edge
          const int text_part = min(geo.text_part_id, kVP), image_part = min(geo.image_part_id, kVP);
          add_bias([&](int e) {
            return row_of(e) < il ? (col_of(e) < il ? image(e) : text_part)
                                  : (col_of(e) < il ? image_part : band(e));
          });
        }
      }
      if (gq0 + kT > L || k0 + kT > Lk) {  // the tile holds the length or the chunk's end
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int i = gq0 + r_lo + ((e >> 1) & 1) * 8, j = k0 + (e >> 2) * 8 + t * 2 + (e & 1);
          if ((i < L) != (j < Lk)) s[e] += mask2;
        }
      }
      if (kWindow && window_cuts(gq0, k0, a.q_start + Sq, a.k_start + a.Sk, geo)) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int i = gq0 + r_lo + ((e >> 1) & 1) * 8, j = k0 + (e >> 2) * 8 + t * 2 + (e & 1);
          if (!window_allowed(i, j, geo)) s[e] += mask2;
        }
      }

      // Online softmax in base 2; l sums this lane's p before the dropout.
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[4 * n + 2 * hr], s[4 * n + 2 * hr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, 2));
        const float m_new = fmaxf(m_run[hr], mx);
        const float alpha = ex2(m_run[hr] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float p = ex2(s[4 * n + 2 * hr + u] - m_new);
            s[4 * n + 2 * hr + u] = p;
            sum += p;
          }
        }
        l_run[hr] = __fmaf_rn(l_run[hr], alpha, sum);
        m_run[hr] = m_new;
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          o_acc[4 * nd + 2 * hr] *= alpha;
          o_acc[4 * nd + 2 * hr + 1] *= alpha;
        }
      }
      if constexpr (kDropout) {  // after l has the full sum; only p.v sees the mask
#pragma unroll
        for (int e = 0; e < 32; ++e)
          s[e] *= keep_of(a.dr, hrow[(e >> 1) & 1], k0 + (e >> 2) * 8 + t * 2 + (e & 1));
      }

      // O += P . V: P as the A fragments (rows g and g + 8 of each 16-key
      // step), V read MN-major.
      uint32_t pa[4][4];
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        pa[kc][0] = pack_bf16(s[8 * kc], s[8 * kc + 1]);
        pa[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
        pa[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
        pa[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
      }
      wg_fence();
#pragma unroll
      for (int kc = 0; kc < kT / 16; ++kc)
        wgmma_rs<1>(o_acc, pa[kc], SD::mn_major(base + M::v(st), kc));
      wg_commit();
      wg_wait_all();
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);  // this warp is done with stage st
  }

  if (!active) return;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = l_run[hr];
    l += __shfl_xor_sync(0xFFFFFFFFu, l, 1);
    l += __shfl_xor_sync(0xFFFFFFFFu, l, 2);
    const int i = q0 + r_lo + hr * 8;  // local row
    if (i >= Sq) continue;
    // No live key (no tile, or only masked pairs): o = 0, lse = -inf.
    const bool empty = m_run[hr] < kEmptyRow2;
    if (l == 0.f) l = 1.f;
    const float inv = empty ? 0.f : 1.f / l;
    __nv_bfloat16* orow = a.o + head0 + static_cast<size_t>(i) * row_stride + t * 2;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<uint32_t*>(orow + nd * 8) =
          pack_bf16(o_acc[4 * nd + 2 * hr] * inv, o_acc[4 * nd + 2 * hr + 1] * inv);
    if (t == 0) lse_bh[i] = empty ? -INFINITY : (m_run[hr] + log2f(l)) * kLn2;
  }
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Tensor map of a [B, S, H * D] bf16 tensor cut into [64, D] boxes (one
// head's 64 rows of one example) with the swizzle of Swz<D>; rows past S
// read as 0.  The encoder, a libcuda function, is looked up at run time.
cudaError_t make_kv_map(CUtensorMap* map, const void* base, int batch, int seq_len, int heads,
                        int head_dim) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  const cuuint64_t row = static_cast<cuuint64_t>(heads) * head_dim;
  const cuuint64_t dims[3] = {row, static_cast<cuuint64_t>(seq_len),
                              static_cast<cuuint64_t>(batch)};  // innermost first
  const cuuint64_t strides[2] = {row * 2, row * 2 * seq_len};  // bytes, dims 1..
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(head_dim), kT, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      head_dim == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D, bool kDropout, bool kWindow>
cudaError_t launch(dim3 grid, cudaStream_t s, const CUtensorMap& tm_k, const CUtensorMap& tm_v,
                   const FwdArgs& a) {
  auto kernel = rel_attention_fwd_kernel<D, kDropout, kWindow>;
  constexpr int smem = Smem<D>::alloc;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kBlockThreads, smem, s>>>(tm_k, tm_v, a);
  return cudaGetLastError();
}

using LaunchFn = decltype(&launch<64, false, false>);

template <int D>
LaunchFn pick(bool drop, bool window) {
  if (drop) return window ? launch<D, true, true> : launch<D, true, false>;
  return window ? launch<D, false, true> : launch<D, false, false>;
}

}  // namespace

// q, o: bf16 [B, S_q, H, D], k, v: bf16 [B, S_k, H, D], contiguous; rel:
// bf16 [H, 64, D] contiguous (rows >= V zero) or null; lengths: int32 [B]
// (global); lse: fp32 [B, H, S_q].  q_start, k_start: the global positions
// of q's row 0 and k's key 0, multiples of 64 (0 without sharding).
// dropout_threshold = round(rate * 2^24) (0: no dropout), keep_scale =
// float32(1 / (1 - rate)), seed: the call's int32 seed, batch_start: global
// index of example 0.  window > 0 selects the sliding-window pattern with
// the global prefix [0, num_global) (num_global > 0; ignored at window 0).
// With the 2D ids, patch_per_row <= 32 (the image id table).
// Launches on `stream`, allocates nothing, returns the CUDA error code.
extern "C" int mmt_rel_attention_fwd(const void* q, const void* k, const void* v, const void* rel,
                                     const void* lengths, void* o, void* lse, int batch,
                                     int seq_q, int seq_k, int q_start, int k_start,
                                     int num_heads, int head_dim, int vocab,
                                     int image_len, int patch_per_row, int core_layers,
                                     int text_max_distance, int image_part_id, int text_part_id,
                                     int window, int num_global, float scale,
                                     int dropout_threshold, float keep_scale, int seed,
                                     int batch_start, void* stream) {
  if (vocab < 0 || vocab > kVP || dropout_threshold < 0 || dropout_threshold > (1 << 24) ||
      window < 0 || (window > 0 && num_global <= 0) || q_start < 0 || k_start < 0 ||
      q_start % kT || k_start % kT || seq_q <= 0 || seq_k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rel != nullptr && image_len > 0 && patch_per_row > kMaxPatchPerRow)
    return static_cast<int>(cudaErrorInvalidValue);
  // The same pattern; keeps r0 + w from overflowing.
  window = min(window, max(q_start + seq_q, k_start + seq_k));
  FwdArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.rel = static_cast<const __nv_bfloat16*>(rel);
  a.lengths = static_cast<const int*>(lengths);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.lse = static_cast<float*>(lse);
  a.Sq = seq_q;
  a.Sk = seq_k;
  a.q_start = q_start;
  a.k_start = k_start;
  a.H = num_heads;
  a.geo = Geometry{image_len,     patch_per_row, core_layers,     text_max_distance,
                   image_part_id, text_part_id,  rel ? vocab : 0, window,
                   num_global};
  a.scale = scale;
  a.dr = Dropout{static_cast<uint32_t>(dropout_threshold), keep_scale,
                 static_cast<uint32_t>(seed), static_cast<uint32_t>(batch_start)};
  const dim3 grid((seq_q + kBlockRows - 1) / kBlockRows, num_heads, batch);
  const bool drop = dropout_threshold > 0;
  LaunchFn fn;
  if (head_dim == 64) {
    fn = pick<64>(drop, window > 0);
  } else if (head_dim == 32) {
    fn = pick<32>(drop, window > 0);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tm_k, tm_v;
  cudaError_t err = make_kv_map(&tm_k, k, batch, seq_k, num_heads, head_dim);
  if (err == cudaSuccess) err = make_kv_map(&tm_v, v, batch, seq_k, num_heads, head_dim);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(fn(grid, static_cast<cudaStream_t>(stream), tm_k, tm_v, a));
}

extern "C" const char* mmt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
