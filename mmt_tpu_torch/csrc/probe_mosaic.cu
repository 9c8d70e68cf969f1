// P3 on Hopper (sm_90a): the six functions of the TPU probe
// scripts/mosaic_probe.py, each as one batched kernel that computes what
// its pallas_call computes.  Nothing on the retrieval or training paths
// calls them.
//
//   probe_strided_roll :26 (site :32)     x [B, 64, 256];
//                                         out[b, i, (j + i) % 256] = x[b, i, j]
//   probe_uniform_dynamic_roll :98 (:103) x [B, 64, 256], s;
//                                         out[b, i, (j + s) % 256] = x[b, i, j]
//   probe_static_unaligned_store :40 (:47) x [B, 8, 64] -> zeros [B, 64, 256],
//                                         out[b, 8:16, 20:84] = x[b]
//   probe_many_static_stores :56 (:65)    x [B, 256, 40] -> zeros [B, 256, 512], for g < 32:
//                                         out[b, 8g:8g+8, o:o+40] = x[b, 8g:8g+8],
//                                         o = max(8g - 12, 0)
//   probe_dynamic_lane_store :76 (:83)    x [B, 8, 64], off -> zeros [B, 64, 256],
//                                         out[b, 0:8, off:off+64] = x[b]
//   probe_small_matmul :115 (:125)        x [B, 256, 128], w [B, 128, 64];
//                                         out[b] = x[b] . w[b] to fp32 accuracy
//
// All fp32.  The scalars s and off are int32 device words that the kernel
// reads, as the TPU's scalar prefetch reads them.  B = 1 is the TPU probe's
// own call.
//
// Where the TPU rolls lanes and stores at unaligned lane offsets, this card
// addresses shared memory and global memory freely; what costs is the
// bytes, so every kernel but the product is one pass over its output at
// the card's memory rate:
// - The rolls bring 32 rows of the tile into shared memory by 16-byte
//   cp.async (two groups of 16 rows: the second loads while the first is
//   written) and write each row at the rotated column in coalesced 16-byte
//   stores.  Each thread reads its chunk's four sources in an order rotated
//   by its lane group, so the 32 lanes of a warp meet 32 banks.
// - The block stores are output-stationary: one pass writes every 16-byte
//   chunk of the output once, x's values or zeros, so no zero fill and box
//   write ever race on an address.  x's rows come through shared memory by
//   cp.async; a chunk is one 16-byte read of them where the column offset
//   is a multiple of 4 (all static offsets of the probe are), else four
//   selects.  A dynamic offset outside [0, 192] leaves the result
//   unspecified (the kernel writes the part of the box inside the tile).
// - The product has no fp32 wgmma: x and w are split into bf16 hi + lo and
//   lo.hi + hi.lo + hi.hi is summed in fp32 on m64n64k16 wgmma (24 products
//   per 64-row block).  The dropped lo.lo term and lo's own rounding leave
//   ~2.5e-4 of absolute error on the TPU probe's inputs, against its atol of
//   1e-3; one bf16 or tf32 product would leave 0.11 or 1.8e-2.  The kernel
//   moves each byte once: a persistent block of one warpgroup (two per SM)
//   walks its instances through a ring of two 32 KB shared-memory slots
//   that bulk copies (cp.async.bulk, mbarriers) fill: per instance w, split
//   once into MN-major 128-byte-swizzled hi / lo tiles that all four of x's
//   64-row blocks go through, then the blocks, each split in registers as
//   wgmma's A operand.  A slot is refilled as soon as it is read, so the
//   next two items load while a block is split, multiplied and stored.
//
// Bound: bytes for all six (each input read once, the output written once;
// the product's 3 x 2 x 256 x 128 x 64 bf16 operations per instance take a
// fifth of its bytes' time).

#include "rel_attention_hopper.cuh"

namespace {

using namespace mmt;

// ---------------------------------------------------------------- rolls

constexpr int kRollRows = 64, kRollCols = 256;
constexpr int kRollBlockRows = 32;  // rows of one block: two blocks per instance
constexpr int kRollGroupRows = 16;  // rows per cp.async group
constexpr int kRollThreads = 256;
constexpr int kRowChunks = kRollCols / 4;

__device__ __forceinline__ float select4(const float (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// out[i, c] = x[i, (c - shift(i)) mod 256], shift(i) = i (strided) or s.
template <bool kStrided>
__global__ void __launch_bounds__(kRollThreads)
roll_kernel(const float* __restrict__ x, const int* __restrict__ shift, float* __restrict__ out) {
  __shared__ __align__(16) float s_x[kRollBlockRows * kRollCols];
  const int inst = blockIdx.x / 2, row0 = (blockIdx.x % 2) * kRollBlockRows;
  const size_t first = (static_cast<size_t>(inst) * kRollRows + row0) * kRollCols;
  const float* xb = x + first;
  float* ob = out + first;
  constexpr int kGroupChunks = kRollGroupRows * kRowChunks;
  const uint32_t sbase = smem_u32(s_x);
#pragma unroll
  for (int grp = 0; grp < kRollBlockRows / kRollGroupRows; ++grp) {
    for (int idx = threadIdx.x; idx < kGroupChunks; idx += kRollThreads) {
      const int e = (grp * kGroupChunks + idx) * 4;
      cp_async16(sbase + 4 * e, xb + e, true);
    }
    cp_async_commit();
  }
  // s mod 256 in [0, 256), as np.roll takes a negative shift.
  const int s = kStrided ? 0 : ((*shift % kRollCols) + kRollCols) % kRollCols;
  // Lane group a = lane / 8 reads a chunk's sources starting at the a-th:
  // the m-th read of lane 8a + b falls in bank 4b + (m + a) % 4 (+ a
  // constant), 32 banks for 32 lanes.
  const int a = (threadIdx.x >> 3) & 3;
#pragma unroll
  for (int grp = 0; grp < kRollBlockRows / kRollGroupRows; ++grp) {
    if (grp == 0) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    for (int idx = threadIdx.x; idx < kGroupChunks; idx += kRollThreads) {
      const int r = grp * kRollGroupRows + idx / kRowChunks, q = idx % kRowChunks;
      const int src = 4 * q - (kStrided ? row0 + r : s);  // source of output column 4q
      const float* row = s_x + r * kRollCols;
      float v[4];  // v[m] = source m + a of the chunk
#pragma unroll
      for (int m = 0; m < 4; ++m) v[m] = row[(src + ((m + a) & 3)) & (kRollCols - 1)];
      const float4 o = make_float4(select4(v, (0 - a) & 3), select4(v, (1 - a) & 3),
                                   select4(v, (2 - a) & 3), select4(v, (3 - a) & 3));
      *reinterpret_cast<float4*>(ob + r * kRollCols + 4 * q) = o;
    }
  }
}

// ---------------------------------------------------------- block stores

// One probe's box: output [kRows, kCols] per instance, x [kXRows, kXCols];
// output row r holds x's row r - kRow0 (when in range) from column col(r).
struct UnalignedBox {  // probe_static_unaligned_store
  static constexpr int kRows = 64, kCols = 256, kXRows = 8, kXCols = 64, kRow0 = 8;
  __device__ static __forceinline__ int col(int, int) { return 20; }
};
struct ManyBoxes {  // probe_many_static_stores: 32 boxes of 8 rows
  static constexpr int kRows = 256, kCols = 512, kXRows = 256, kXCols = 40, kRow0 = 0;
  __device__ static __forceinline__ int col(int r, int) { return max(8 * (r / 8) - 12, 0); }
};
struct LaneBox {  // probe_dynamic_lane_store
  static constexpr int kRows = 64, kCols = 256, kXRows = 8, kXCols = 64, kRow0 = 0;
  __device__ static __forceinline__ int col(int, int off) { return off; }
};

constexpr int kBoxBlockRows = 64;  // output rows of one block
constexpr int kBoxThreads = 256;

template <class Box>
__global__ void __launch_bounds__(kBoxThreads)
box_store_kernel(const float* __restrict__ x, const int* __restrict__ off_ptr,
                 float* __restrict__ out) {
  constexpr int kBlocks = Box::kRows / kBoxBlockRows;
  constexpr int kStageRows = Box::kXRows < kBoxBlockRows ? Box::kXRows : kBoxBlockRows;
  static_assert(Box::kRows % kBoxBlockRows == 0 && Box::kXCols % 4 == 0, "box shape");
  __shared__ __align__(16) float s_x[kStageRows * Box::kXCols];
  const int inst = blockIdx.x / kBlocks, r0 = (blockIdx.x % kBlocks) * kBoxBlockRows;
  // x's rows that land in this block's rows [r0, r0 + 64).
  const int x_lo = max(r0 - Box::kRow0, 0);
  const int x_hi = min(r0 + kBoxBlockRows - Box::kRow0, Box::kXRows);
  const float* xb = x + (static_cast<size_t>(inst) * Box::kXRows + x_lo) * Box::kXCols;
  const int staged = max(x_hi - x_lo, 0) * Box::kXCols / 4;
  for (int idx = threadIdx.x; idx < staged; idx += kBoxThreads)
    cp_async16(smem_u32(s_x + 4 * idx), xb + 4 * idx, true);
  cp_async_commit();
  const int off = off_ptr != nullptr ? *off_ptr : 0;
  cp_async_wait<0>();
  __syncthreads();
  constexpr int kChunks = Box::kCols / 4;
  float* ob = out + (static_cast<size_t>(inst) * Box::kRows + r0) * Box::kCols;
  for (int idx = threadIdx.x; idx < kBoxBlockRows * kChunks; idx += kBoxThreads) {
    const int r = idx / kChunks, q = idx % kChunks;
    const int xr = r0 + r - Box::kRow0;  // x's row, if in [x_lo, x_hi)
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (xr >= x_lo && xr < x_hi) {
      const int c0 = Box::col(r0 + r, off);
      const int xc = 4 * q - c0;  // x's column of output column 4q
      const float* xrow = s_x + (xr - x_lo) * Box::kXCols;
      if ((c0 & 3) == 0) {
        if (xc >= 0 && xc < Box::kXCols) v = *reinterpret_cast<const float4*>(xrow + xc);
      } else {
        float e[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = xc + k;
          e[k] = c >= 0 && c < Box::kXCols ? xrow[c] : 0.f;
        }
        v = make_float4(e[0], e[1], e[2], e[3]);
      }
    }
    *reinterpret_cast<float4*>(ob + r * Box::kCols + 4 * q) = v;
  }
}

// --------------------------------------------------------------- product

constexpr int kMmM = 256, kMmK = 128, kMmN = 64;
constexpr int kMmBlocks = kMmM / kT;      // x's 64-row blocks per instance
constexpr int kMmItems = 1 + kMmBlocks;   // ring items per instance: w, then the blocks
constexpr int kMmItemFloats = kT * kMmK;  // one item: 32 KB
static_assert(kMmItemFloats == kMmK * kMmN, "w and an x block fill one ring slot alike");
constexpr int kMmSlotBytes = 4 * kMmItemFloats;
constexpr int kMmSlots = 2;           // ring depth of a block
constexpr int kMmBlocksPerSm = 2;     // 2 x 97 KB of shared memory
using MmTile = Swz<64>;               // [64, 64] bf16, 8 KB
// Shared-memory plan from a 1024-aligned base: the ring's fp32 slots; w's
// hi and lo tiles (K rows 0-63 and 64-127 each, MN-major); the slots'
// mbarriers.
constexpr int kWHi = kMmSlots * kMmSlotBytes, kWLo = kWHi + 2 * MmTile::kBytes;
constexpr int kMmFull = kWLo + 2 * MmTile::kBytes;
constexpr int kMmSmem = kMmFull + 8 * kMmSlots + 1024;  // + slack to align the base

// hi = bf16(v), lo = bf16(v - hi), four values packed as bf16 pairs.
__device__ __forceinline__ void split4(float4 v, uint2& hi, uint2& lo) {
  const __nv_bfloat162 h01 = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 h23 = __floats2bfloat162_rn(v.z, v.w);
  const float2 f01 = __bfloat1622float2(h01), f23 = __bfloat1622float2(h23);
  hi = make_uint2(*reinterpret_cast<const uint32_t*>(&h01),
                  *reinterpret_cast<const uint32_t*>(&h23));
  lo = make_uint2(pack_bf16(v.x - f01.x, v.y - f01.y), pack_bf16(v.z - f23.x, v.w - f23.y));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Ring item t of this block (instances blockIdx.x, + gridDim.x, ...; w,
// then x's four row blocks, each one contiguous 32 KB) into slot t % 2 by
// one bulk copy that completes a transaction on the slot's barrier; none
// past the batch.  One thread.
__device__ __forceinline__ void mm_fetch(uint32_t base, const float* x, const float* w, int batch,
                                         int t) {
  const int inst = blockIdx.x + (t / kMmItems) * gridDim.x, part = t % kMmItems;
  if (inst >= batch) return;
  const float* src = part == 0 ? w + static_cast<size_t>(inst) * kMmItemFloats
                               : x + (static_cast<size_t>(inst) * kMmBlocks + part - 1) *
                                         kMmItemFloats;
  const int slot = t % kMmSlots;
  const uint32_t bar = base + kMmFull + 8 * slot;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(kMmSlotBytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(base + slot * kMmSlotBytes), "l"(src), "r"(kMmSlotBytes), "r"(bar)
      : "memory");
}

// The k of the product that x's column (w's row) p feeds.  Thread q = lane
// % 4 of a warp reads columns [16 s + 4 q, 16 s + 4 q + 4) of its two rows
// as one float4 per 16-deep step s; wgmma's A registers give it k = 2 q,
// 2 q + 1 (the float4's first two) and 8 + 2 q, 9 + 2 q (its last two) of
// the step.  w's rows are stored at the same k, so the product is x . w.
__device__ __forceinline__ int mm_k(int p) {
  const int q = (p >> 2) & 3, j = p & 3;
  return (p & ~15) + (j < 2 ? 2 * q + j : 6 + 2 * q + j);
}

// A persistent block of one warpgroup walks its instances through a ring of
// two 32 KB slots: per instance w (split into the bf16 hi / lo tiles), then
// x's four 64-row blocks (split in registers, the A operand of wgmma).
// Each slot is refilled as soon as it is read, so two bulk copies stay in
// flight while the block splits, multiplies and stores.
__global__ void __launch_bounds__(kThreads, kMmBlocksPerSm)
small_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ out, int batch) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int slot = 0; slot < kMmSlots; ++slot) mbar_init(base + kMmFull + 8 * slot, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < kMmSlots; ++t) mm_fetch(base, x, w, batch, t);
  }
  __syncthreads();
  const int warp = tid / 32, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int items = kMmItems * ((batch - blockIdx.x + gridDim.x - 1) / gridDim.x);
  for (int t = 0; t < items; ++t) {
    const int slot = t % kMmSlots, part = t % kMmItems;
    mbar_wait(base + kMmFull + 8 * slot, (t / kMmSlots) & 1);
    const float* s_in = reinterpret_cast<const float*>(smem + slot * kMmSlotBytes);
    if (part == 0) {
      // w -> hi / lo tiles, row p at k = mm_k(p), once every warp is past
      // the previous instance's products.
      if (t > 0) __syncthreads();
      for (int idx = tid; idx < kMmK * kMmN / 4; idx += kThreads) {
        const int p = idx / (kMmN / 4), c = (idx % (kMmN / 4)) * 4, k = mm_k(p);
        uint2 hi, lo;
        split4(*reinterpret_cast<const float4*>(s_in + p * kMmN + c), hi, lo);
        const int at = (k / kT) * MmTile::kBytes + MmTile::elem(k % kT, c);
        *reinterpret_cast<uint2*>(smem + kWHi + at) = hi;
        *reinterpret_cast<uint2*>(smem + kWLo + at) = lo;
      }
      fence_async_proxy();
      __syncthreads();  // the tiles are written, the slot is read
      if (tid == 0) mm_fetch(base, x, w, batch, t + kMmSlots);
      continue;
    }
    // Rows 16 warp + g + 8 hr of the block, four columns per step.
    float4 v[kMmK / 16][2];
#pragma unroll
    for (int s = 0; s < kMmK / 16; ++s)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        v[s][hr] = *reinterpret_cast<const float4*>(
            s_in + (16 * warp + g + 8 * hr) * kMmK + 16 * s + 4 * q);
    __syncthreads();  // every thread holds its rows: refill the slot
    if (tid == 0) mm_fetch(base, x, w, batch, t + kMmSlots);
    // A registers of step s: [0] row g, k 2q; [1] row g + 8, k 2q; [2] row
    // g, k 8 + 2q; [3] row g + 8, k 8 + 2q (two bf16 each).
    uint32_t a_hi[kMmK / 16][4], a_lo[kMmK / 16][4];
#pragma unroll
    for (int s = 0; s < kMmK / 16; ++s)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        uint2 hi, lo;
        split4(v[s][hr], hi, lo);
        a_hi[s][hr] = hi.x, a_hi[s][2 + hr] = hi.y;
        a_lo[s][hr] = lo.x, a_lo[s][2 + hr] = lo.y;
      }
    float acc[32];
    zero(acc);
    wg_fence();
    // The small terms first, then hi . hi.
#pragma unroll
    for (int s = 0; s < kMmK / 16; ++s) {
      const int tile = (s / 4) * MmTile::kBytes, kk = s % 4;
      wgmma_rs<1>(acc, a_lo[s], MmTile::mn_major(base + kWHi + tile, kk));
      wgmma_rs<1>(acc, a_hi[s], MmTile::mn_major(base + kWLo + tile, kk));
    }
#pragma unroll
    for (int s = 0; s < kMmK / 16; ++s)
      wgmma_rs<1>(acc, a_hi[s], MmTile::mn_major(base + kWHi + (s / 4) * MmTile::kBytes, s % 4));
    wg_commit();
    wg_wait_all();
    // acc[4 n + 2 hr + e]: row 16 warp + g + 8 hr, column 8 n + 2 q + e.
    const int inst = blockIdx.x + (t / kMmItems) * gridDim.x;
    float* ob = out + (static_cast<size_t>(inst) * kMmM + (part - 1) * kT) * kMmN;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = warp * 16 + g + 8 * hr;
#pragma unroll
      for (int n = 0; n < kMmN / 8; ++n)
        *reinterpret_cast<float2*>(ob + r * kMmN + 8 * n + 2 * q) =
            make_float2(acc[4 * n + 2 * hr], acc[4 * n + 2 * hr + 1]);
    }
  }
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

cudaError_t bad_batch(int batch) {
  return batch <= 0 ? cudaErrorInvalidValue : cudaSuccess;
}

template <class Box>
int launch_box(const void* x, const void* off, void* out, int batch, void* stream) {
  if (const cudaError_t err = bad_batch(batch)) return static_cast<int>(err);
  box_store_kernel<Box><<<batch * (Box::kRows / kBoxBlockRows), kBoxThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(off), static_cast<float*>(out));
  return last_error();
}

template <bool kStrided>
int launch_roll(const void* x, const void* shift, void* out, int batch, void* stream) {
  if (const cudaError_t err = bad_batch(batch)) return static_cast<int>(err);
  roll_kernel<kStrided><<<2 * batch, kRollThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(shift), static_cast<float*>(out));
  return last_error();
}

}  // namespace

// Every function launches on `stream`, allocates nothing and returns
// cudaGetLastError().  Pointers are device pointers to contiguous fp32
// tensors (int32 for shift and off, one element); batch >= 1.

// x, out: [batch, 64, 256]; out[b, i, (j + i) % 256] = x[b, i, j].
extern "C" int mmt_probe_mosaic_strided_roll(const void* x, void* out, int batch, void* stream) {
  return launch_roll<true>(x, nullptr, out, batch, stream);
}

// x, out: [batch, 64, 256]; out = roll(x, *shift, -1) for any int32 shift.
extern "C" int mmt_probe_mosaic_uniform_dynamic_roll(const void* x, const void* shift, void* out,
                                                     int batch, void* stream) {
  return launch_roll<false>(x, shift, out, batch, stream);
}

// x: [batch, 8, 64]; out: [batch, 64, 256], zeros but out[:, 8:16, 20:84] = x.
extern "C" int mmt_probe_mosaic_static_unaligned_store(const void* x, void* out, int batch,
                                                       void* stream) {
  return launch_box<UnalignedBox>(x, nullptr, out, batch, stream);
}

// x: [batch, 256, 40]; out: [batch, 256, 512], zeros but the 32 boxes.
extern "C" int mmt_probe_mosaic_many_static_stores(const void* x, void* out, int batch,
                                                   void* stream) {
  return launch_box<ManyBoxes>(x, nullptr, out, batch, stream);
}

// x: [batch, 8, 64]; out: [batch, 64, 256], zeros but out[:, 0:8, off:off + 64] = x,
// 0 <= *off <= 192 (else unspecified).
extern "C" int mmt_probe_mosaic_dynamic_lane_store(const void* x, const void* off, void* out,
                                                   int batch, void* stream) {
  return launch_box<LaneBox>(x, off, out, batch, stream);
}

// Blocks of the product's launch at `batch` on the current device: its SMs
// times the blocks resident on one (found once per device, which also sets
// the kernel's shared-memory limit there), at most `batch`; a negative CUDA
// error code on failure.
extern "C" int mmt_probe_mosaic_small_matmul_grid(int batch) {
  if (const cudaError_t err = bad_batch(batch)) return -static_cast<int>(err);
  constexpr int kMaxDevices = 64;
  static int resident[kMaxDevices] = {};  // 0: not yet found
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && device >= kMaxDevices) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess && resident[device] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(small_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMmSmem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, small_matmul_kernel,
                                                          kThreads, kMmSmem);
    if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
    if (err == cudaSuccess) resident[device] = sms * per_sm;
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  return batch < resident[device] ? batch : resident[device];
}

// x: [batch, 256, 128]; w: [batch, 128, 64]; out: [batch, 256, 64] = x . w.
// A persistent grid: as many blocks as are resident at once on the card's
// SMs, at most one per instance.
extern "C" int mmt_probe_mosaic_small_matmul(const void* x, const void* w, void* out, int batch,
                                             void* stream) {
  const int grid = mmt_probe_mosaic_small_matmul_grid(batch);
  if (grid < 0) return -grid;
  small_matmul_kernel<<<grid, kThreads, kMmSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(out),
      batch);
  return last_error();
}

extern "C" const char* mmt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
