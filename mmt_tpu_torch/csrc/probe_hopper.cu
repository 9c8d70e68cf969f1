// Primitive probes for Hopper (sm_90a): does this toolchain build, and this
// card run right, each primitive the redesigned attention kernels need?
//
// Replaces the TPU probe scripts/mosaic_probe.py (probe_strided_roll,
// probe_static_unaligned_store, probe_many_static_stores,
// probe_dynamic_lane_store, probe_uniform_dynamic_roll, probe_small_matmul):
// six tiny kernels, each compiled, run and compared with numpy.  The TPU
// probes ask for lane rolls and unaligned lane stores, that chip's way to
// the skewed and transposed tiles of the band path; the card's way to those
// layouts is the swizzled TMA tile and ldmatrix.trans / stmatrix, and its
// small matmul is wgmma.  Each probe below is one tiny kernel with a result
// the caller checks exactly (copies, permutations, integer-valued sums) or
// to a stated tolerance (the product).  Nothing on the retrieval or
// training paths calls them.
//
//   wgmma_m64n64k16_bf16      C = A . B^T, A and B [64, 64] bf16 from
//                             128-byte-swizzled shared memory through matrix
//                             descriptors; fence / commit_group / wait_group
//   tma_load_2d               a [64, 64] bf16 box per block by
//                             cp.async.bulk.tensor with a 128-byte swizzle,
//                             mbarrier with expect_tx, read back unswizzled
//   tma_store_2d              the reverse: swizzled shared tile to global
//   cp_async_ring             16-byte cp.async through a 3-stage ring
//   ldmatrix_trans_stmatrix   a [64, 64] bf16 transpose in registers
//   cluster_dsmem             a cluster of 2 reading the neighbour's shared
//                             memory
//   smem_227k                 232448 bytes of dynamic shared memory
//   setmaxnreg                register hand-over between warpgroups
//   red_add_v4_f32            16-byte vector reduction to global memory
//
// All are bound by launch latency at these sizes; the probe reports status,
// not speed.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kTile = 64;                       // rows and columns of a tile
constexpr int kTileBytes = kTile * kTile * 2;   // bf16
constexpr int kMaxSmemBytes = 232448;           // 227 KB, the opt-in limit
constexpr int kEncodeErrorBase = 10000;         // return code of a CUresult

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of (row, col) in a [64, 64] bf16 tile under the 128-byte
// swizzle: 16-byte chunk c of row r sits at chunk c ^ (r & 7).
__device__ __forceinline__ int swizzled(int r, int c) {
  return r * kTile + ((((c >> 3) ^ (r & 7)) << 3) | (c & 7));
}

// ---------------------------------------------------------------- wgmma

__device__ __forceinline__ uint64_t wgmma_desc(const __nv_bfloat16* p) {
  uint64_t d = (static_cast<uint64_t>(smem_u32(p)) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>(16 >> 4) << 16;    // leading byte offset (unused)
  d |= static_cast<uint64_t>(1024 >> 4) << 32;  // stride: 8 rows of 128 bytes
  d |= 1ull << 62;                              // 128-byte swizzle
  return d;
}

__global__ void __launch_bounds__(128)
wgmma_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
             float* __restrict__ c) {
  __shared__ __align__(1024) __nv_bfloat16 s_a[kTile * kTile];
  __shared__ __align__(1024) __nv_bfloat16 s_b[kTile * kTile];
  for (int idx = threadIdx.x; idx < kTile * 8; idx += 128) {
    const int r = idx >> 3, ch = idx & 7;
    *reinterpret_cast<uint4*>(s_a + swizzled(r, ch * 8)) =
        *reinterpret_cast<const uint4*>(a + r * kTile + ch * 8);
    *reinterpret_cast<uint4*>(s_b + swizzled(r, ch * 8)) =
        *reinterpret_cast<const uint4*>(b + r * kTile + ch * 8);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = wgmma_desc(s_a + kk * 16), db = wgmma_desc(s_b + kk * 16);
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));  // accumulate onto the zeroed d
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");

  // Accumulator layout: warp w owns rows 16 w + [0, 16); a lane holds, for
  // each 8-column group n, (row g, cols 2 t, 2 t + 1) and (row g + 8, same).
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = warp * 16 + (lane >> 2), col = (lane & 3) * 2;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    c[row * kTile + n * 8 + col] = d[n * 4];
    c[row * kTile + n * 8 + col + 1] = d[n * 4 + 1];
    c[(row + 8) * kTile + n * 8 + col] = d[n * 4 + 2];
    c[(row + 8) * kTile + n * 8 + col + 1] = d[n * 4 + 3];
  }
}

// ------------------------------------------------------------------ TMA

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Tensor map of a row-major [rows, 64] bf16 matrix cut into [64, 64] boxes
// with the 128-byte swizzle.  The encoder (a libcuda function) is looked up at run
// time, so the library does not link against libcuda.
int make_tile_map(CUtensorMap* map, void* base, int rows) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
  const cudaError_t err =
      cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (found != cudaDriverEntryPointSuccess || fn == nullptr)
    return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[2] = {kTile, static_cast<cuuint64_t>(rows)};  // innermost first
  const cuuint64_t strides[1] = {kTile * 2};                          // bytes, dims 1..
  const cuuint32_t box[2] = {kTile, kTile};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = reinterpret_cast<EncodeTiledFn>(fn)(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeErrorBase + static_cast<int>(res);
}

__global__ void __launch_bounds__(128)
tma_load_kernel(const __grid_constant__ CUtensorMap map, __nv_bfloat16* __restrict__ out) {
  __shared__ __align__(1024) __nv_bfloat16 tile[kTile * kTile];
  __shared__ __align__(8) uint64_t bar;
  const uint32_t bar_addr = smem_u32(&bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_addr) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar_addr),
                 "r"(kTileBytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(tile)),
        "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar_addr), "r"(0),
        "r"(static_cast<int>(blockIdx.x) * kTile)
        : "memory");
  }
  // Every thread waits for phase 0 of the barrier to complete.
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar_addr)
      : "memory");
  for (int idx = threadIdx.x; idx < kTile * kTile; idx += 128) {
    const int r = idx / kTile, c = idx % kTile;
    out[(blockIdx.x * kTile + r) * kTile + c] = tile[swizzled(r, c)];
  }
}

__global__ void __launch_bounds__(128)
tma_store_kernel(const __grid_constant__ CUtensorMap map, const __nv_bfloat16* __restrict__ in) {
  __shared__ __align__(1024) __nv_bfloat16 tile[kTile * kTile];
  for (int idx = threadIdx.x; idx < kTile * kTile; idx += 128) {
    const int r = idx / kTile, c = idx % kTile;
    tile[swizzled(r, c)] = in[(blockIdx.x * kTile + r) * kTile + c];
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile(
        "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
            reinterpret_cast<uint64_t>(&map)),
        "r"(smem_u32(tile)), "r"(0), "r"(static_cast<int>(blockIdx.x) * kTile)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ------------------------------------------------------- cp.async ring

constexpr int kStages = 3;

__device__ __forceinline__ void ring_fetch(__nv_bfloat16* stage, const __nv_bfloat16* src) {
  for (int ch = threadIdx.x; ch < kTileBytes / 16; ch += 128)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(stage + ch * 8)),
                 "l"(src + ch * 8));
}

// One block streams `tiles` tiles of 8 KB through a 3-stage ring; each tile
// is written out by other threads than those that fetched it.
__global__ void __launch_bounds__(128)
cp_async_ring_kernel(const __nv_bfloat16* __restrict__ in, __nv_bfloat16* __restrict__ out,
                     int tiles) {
  __shared__ __align__(16) __nv_bfloat16 ring[kStages][kTile * kTile];
  constexpr int kElems = kTile * kTile;
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) ring_fetch(ring[s], in + s * kElems);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int t = 0; t < tiles; ++t) {
    // Stage (t + 2) % 3 was read in iteration t - 1, before its last barrier.
    if (t + kStages - 1 < tiles)
      ring_fetch(ring[(t + kStages - 1) % kStages], in + (t + kStages - 1) * kElems);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");  // tile t has landed
    __syncthreads();
    const __nv_bfloat16* stage = ring[t % kStages];
    for (int ch = threadIdx.x; ch < kElems / 8; ch += 128) {
      const int src = (ch + 37) % (kElems / 8);
      *reinterpret_cast<uint4*>(out + t * kElems + src * 8) =
          *reinterpret_cast<const uint4*>(stage + src * 8);
    }
    __syncthreads();
  }
}

// ------------------------------------------------- ldmatrix / stmatrix

// out = in^T for a [64, 64] bf16 tile: each warp loads 16 x 16 blocks as four
// transposed 8 x 8 matrices (ldmatrix.x4.trans) and stores them at the
// mirrored place (stmatrix.x4).
__global__ void __launch_bounds__(128)
transpose_kernel(const __nv_bfloat16* __restrict__ in, __nv_bfloat16* __restrict__ out) {
  constexpr int LD = kTile + 8;
  __shared__ __align__(16) __nv_bfloat16 s_in[kTile * LD];
  __shared__ __align__(16) __nv_bfloat16 s_out[kTile * LD];
  for (int idx = threadIdx.x; idx < kTile * 8; idx += 128) {
    const int r = idx >> 3, ch = idx & 7;
    *reinterpret_cast<uint4*>(s_in + r * LD + ch * 8) =
        *reinterpret_cast<const uint4*>(in + r * kTile + ch * 8);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // Lane l addresses row l % 8 of matrix l / 8; matrix m covers rows
  // 8 (m & 1) + [0, 8) and columns 8 (m >> 1) + [0, 8) of the 16 x 16 block.
  const int m = lane >> 3, r = lane & 7;
  const int rb = (m & 1) * 8, cb = (m >> 1) * 8;
#pragma unroll
  for (int blk = 0; blk < kTile / 16; ++blk) {
    uint32_t x0, x1, x2, x3;
    const uint32_t src = smem_u32(s_in + (warp * 16 + rb + r) * LD + blk * 16 + cb);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(x0), "=r"(x1), "=r"(x2), "=r"(x3)
                 : "r"(src));
    const uint32_t dst = smem_u32(s_out + (blk * 16 + cb + r) * LD + warp * 16 + rb);
    asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                 "r"(x0), "r"(x1), "r"(x2), "r"(x3)
                 : "memory");
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kTile * 8; idx += 128) {
    const int rr = idx >> 3, ch = idx & 7;
    *reinterpret_cast<uint4*>(out + rr * kTile + ch * 8) =
        *reinterpret_cast<const uint4*>(s_out + rr * LD + ch * 8);
  }
}

// --------------------------------------------------------- cluster dsmem

constexpr int kClusterElems = 256;

// out[b] = in[b ^ 1]: each block of a cluster of 2 fills its shared memory
// and reads its neighbour's.
__global__ void __launch_bounds__(kClusterElems)
cluster_kernel(const float* __restrict__ in, float* __restrict__ out) {
  __shared__ float mine[kClusterElems];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  mine[threadIdx.x] = in[blockIdx.x * kClusterElems + threadIdx.x];
  cluster.sync();
  const float* theirs = cluster.map_shared_rank(mine, rank ^ 1u);
  out[blockIdx.x * kClusterElems + threadIdx.x] = theirs[threadIdx.x];
  cluster.sync();  // the neighbour's shared memory outlives the read
}

// ------------------------------------------------------------ smem 227 KB

// out = reversed(in) for 58112 words through one block's dynamic shared memory.
__global__ void __launch_bounds__(256)
smem_kernel(const int* __restrict__ in, int* __restrict__ out) {
  extern __shared__ __align__(16) int words[];
  constexpr int kWords = kMaxSmemBytes / 4;
  for (int i = threadIdx.x; i < kWords; i += 256) words[i] = in[i];
  __syncthreads();
  for (int i = threadIdx.x; i < kWords; i += 256) out[i] = words[kWords - 1 - i];
}

// ------------------------------------------------------------- setmaxnreg

// Three warpgroups: the first gives registers up (40), the other two take
// them (232), then each computes out = 3 in + 1 on its third of the data.
// The branches never meet again: the compiler honours setmaxnreg only then.
__global__ void __launch_bounds__(384, 1)
setmaxnreg_kernel(const float* __restrict__ in, float* __restrict__ out) {
  const int i = blockIdx.x * 384 + threadIdx.x;
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    out[i] = 3.f * in[i] + 1.f;
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    out[i] = 3.f * in[i] + 1.f;
  }
}

// ---------------------------------------------------------- red.add.v4

// out[0:cols] += in[block, 0:cols] with one 16-byte reduction per thread.
__global__ void __launch_bounds__(128)
red_add_kernel(const float* __restrict__ in, float* __restrict__ out, int cols) {
  const int c = threadIdx.x * 4;
  if (c >= cols) return;
  const float4 val = *reinterpret_cast<const float4*>(in + blockIdx.x * cols + c);
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(out + c), "f"(val.x),
               "f"(val.y), "f"(val.z), "f"(val.w)
               : "memory");
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// Every function launches on `stream`, allocates nothing and returns
// cudaGetLastError() (or, from the tensor-map encoder, 10000 + the encoder's
// CUresult).  Pointers are device pointers to contiguous, 16-byte aligned
// tensors.

// a, b: bf16 [64, 64]; c: fp32 [64, 64] = a . b^T.
extern "C" int mmt_probe_wgmma(const void* a, const void* b, void* c, void* stream) {
  wgmma_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<float*>(c));
  return last_error();
}

// in, out: bf16 [rows, 64], rows a multiple of 64; out = in.
extern "C" int mmt_probe_tma_load(const void* in, void* out, int rows, void* stream) {
  if (rows <= 0 || rows % kTile) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  if (const int err = make_tile_map(&map, const_cast<void*>(in), rows)) return err;
  tma_load_kernel<<<rows / kTile, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<__nv_bfloat16*>(out));
  return last_error();
}

// in, out: bf16 [rows, 64], rows a multiple of 64; out = in.
extern "C" int mmt_probe_tma_store(const void* in, void* out, int rows, void* stream) {
  if (rows <= 0 || rows % kTile) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  if (const int err = make_tile_map(&map, out, rows)) return err;
  tma_store_kernel<<<rows / kTile, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<const __nv_bfloat16*>(in));
  return last_error();
}

// in, out: bf16 [tiles, 64, 64]; out = in.
extern "C" int mmt_probe_cp_async_ring(const void* in, void* out, int tiles, void* stream) {
  if (tiles <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cp_async_ring_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(in), static_cast<__nv_bfloat16*>(out), tiles);
  return last_error();
}

// in, out: bf16 [64, 64]; out = in^T.
extern "C" int mmt_probe_ldmatrix_stmatrix(const void* in, void* out, void* stream) {
  transpose_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(in), static_cast<__nv_bfloat16*>(out));
  return last_error();
}

// in, out: fp32 [2 * pairs, 256]; out[b] = in[b ^ 1].
extern "C" int mmt_probe_cluster_dsmem(const void* in, void* out, int pairs, void* stream) {
  if (pairs <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 2;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(2 * pairs);
  config.blockDim = dim3(kClusterElems);
  config.dynamicSmemBytes = 0;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = &attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, cluster_kernel,
                                             static_cast<const float*>(in),
                                             static_cast<float*>(out));
  return err != cudaSuccess ? static_cast<int>(err) : last_error();
}

// in, out: int32 [58112]; out = reversed(in).
extern "C" int mmt_probe_smem_227k(const void* in, void* out, void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  smem_kernel<<<1, 256, kMaxSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(in), static_cast<int*>(out));
  return last_error();
}

// in, out: fp32 [384 * blocks]; out = 3 in + 1.
extern "C" int mmt_probe_setmaxnreg(const void* in, void* out, int blocks, void* stream) {
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  setmaxnreg_kernel<<<blocks, 384, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out));
  return last_error();
}

// in: fp32 [rows, cols], cols a multiple of 4 and <= 512; out: fp32 [cols],
// zeroed by the caller; out += sum over rows.
extern "C" int mmt_probe_red_add_v4(const void* in, void* out, int rows, int cols,
                                    void* stream) {
  if (rows <= 0 || cols <= 0 || cols % 4 || cols > 512)
    return static_cast<int>(cudaErrorInvalidValue);
  red_add_kernel<<<rows, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), cols);
  return last_error();
}

extern "C" const char* mmt_cuda_error_string(int code) {
  if (code >= kEncodeErrorBase) return "cuTensorMapEncodeTiled failed";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
