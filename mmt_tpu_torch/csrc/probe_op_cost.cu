// Op-cost probe for Hopper (sm_90a): what each op family of the
// relative-attention forward costs inside that kernel's grid and tile walk.
//
// Replaces the TPU probe scripts/op_cost_probe.py (make / bench): the
// flagship kernel's grid, a common baseline, one op family added per
// variant; a variant's time minus the baseline's is that family's cost over
// the grid.  Nothing on the retrieval or training paths calls it.
//
// Grid and walk are rel_attention_fwd.cu's: one block of 4 warps per 64
// query rows of one (batch, head); key tiles of 64 with k0 < L_b, a query
// tile with q0 >= L_b writes 0.  Every variant writes one float per row,
//
//   out[b, h, i] = sum_{j < 64 * ceil(L_b / 64)} x(i, j) + qr[i, 0] (+ extra)
//
// so that nothing it computes is dead code.  The baseline loads the q tile,
// computes qr = q_tile . R_h^T, loads each k tile as the production kernel
// does and forms x = q_i . k_j by mma.sync.  Variants (VARIANT below):
//
//   ids        x += float(relative_id(i, j))        closed-form id per element
//   gather     x += qr[i, id(i, j)] (id < V)        ids + the shared-memory
//              gather: its own cost is gather - ids
//   rank1      x += qr[i, id_tile]                  the far-tile bias (id D
//              right of the diagonal tile, 2D on and left of it)
//   mask       x += -10000 where (i < L) != (j < L) the length term
//   window     x += -10000 where the pattern disallows (i, j)
//   hash       x *= dropout keep factor             hash + compare + multiply
//   exp        x = exp2(x * scale * log2 e)
//   reduce     out = logsumexp_j(x * scale) + qr[i, 0]: exp plus the row max
//              and row sum by shuffles per tile and the online rescale of
//              the running sum; its own cost is reduce - exp
//   pv         extra = sum_d (bf16(x) . V)[i, d]    V tile stored transposed
//              element by element, P repacked to bf16, P . V by mma.sync
//   kt_store   extra = sum_j sum_{d = i mod 8 (8)} v[j, d]: the transposed
//              V tile written element by element (as pv), its mma B
//              fragments read back and summed, no product
//   ldmatrix_trans  the same extra: V tile stored row-major with 16-byte
//              stores, B fragments by ldmatrix.trans
//   cp_async   the baseline with the k loads double-buffered by 16-byte
//              cp.async + wait_group
//   wgmma_qk   the baseline with q . k^T (and qr) by wgmma m64n64k16 from
//              128-byte-swizzled shared memory
//   atomics    the baseline plus the dq pass's epilogue pattern: 49 x 64
//              fp32 global atomics per block (rows 0..48 of the q tile
//              added into out2[b, h, :49, :])
//
// Bound: the baseline's 2 * 64 * 64 * D FLOPs per visited tile against the
// bytes of q and k read once; the probe reports times, not a roofline.

#include <utility>

#include "rel_attention_common.cuh"

namespace {

using namespace mmt;

enum Variant {
  kBase = 0, kIds, kGather, kRank1, kMask, kWindow, kHash, kExp, kReduce, kPv, kKtStore,
  kLdmatrixTrans, kCpAsync, kWgmmaQk, kAtomics, kNumVariants
};

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A [64, 64] bf16 tile into shared memory, 128 bytes per row, 16-byte chunk
// c of row r at chunk position c ^ (r & 7): the 128-byte swizzle wgmma and
// TMA use.  Rows >= rows_valid are zero.
__device__ __forceinline__ void load_tile_swizzled(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                   int rows_valid, size_t row_stride) {
  for (int idx = threadIdx.x; idx < 64 * 8; idx += kThreads) {
    const int r = idx >> 3, c = idx & 7;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid) val = *reinterpret_cast<const uint4*>(src + r * row_stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * 64 + ((c ^ (r & 7)) << 3)) = val;
  }
}

// Shared-memory matrix descriptor of a K-major, 128-byte-swizzled tile:
// start address, leading byte offset 16 (unused with a swizzle), stride
// byte offset 1024 (8 rows of 128 bytes), layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t wgmma_desc(const __nv_bfloat16* p) {
  uint64_t d = (static_cast<uint64_t>(smem_u32(p)) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>(16 >> 4) << 16;
  d |= static_cast<uint64_t>(1024 >> 4) << 32;
  d |= 1ull << 62;
  return d;
}

// acc (+)= A . B^T for a [64, 16] slice of A and a [64, 16] slice of B.
__device__ __forceinline__ void wgmma_m64n64k16(float (&c)[8][4], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(c[0][0]), "+f"(c[0][1]), "+f"(c[0][2]), "+f"(c[0][3]), "+f"(c[1][0]),
        "+f"(c[1][1]), "+f"(c[1][2]), "+f"(c[1][3]), "+f"(c[2][0]), "+f"(c[2][1]),
        "+f"(c[2][2]), "+f"(c[2][3]), "+f"(c[3][0]), "+f"(c[3][1]), "+f"(c[3][2]),
        "+f"(c[3][3]), "+f"(c[4][0]), "+f"(c[4][1]), "+f"(c[4][2]), "+f"(c[4][3]),
        "+f"(c[5][0]), "+f"(c[5][1]), "+f"(c[5][2]), "+f"(c[5][3]), "+f"(c[6][0]),
        "+f"(c[6][1]), "+f"(c[6][2]), "+f"(c[6][3]), "+f"(c[7][0]), "+f"(c[7][1]),
        "+f"(c[7][2]), "+f"(c[7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// acc = A . B^T for two swizzled [64, 64] tiles (4 k-steps of 16).
__device__ __forceinline__ void wgmma_abt(float (&acc)[8][4], const __nv_bfloat16* a,
                                          const __nv_bfloat16* b) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64k16(acc, wgmma_desc(a + kk * 16), wgmma_desc(b + kk * 16), kk > 0);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  // The accumulators are written until the wait returns: keep the compiler
  // from reading them before it.
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[n][e])::"memory");
  }
}

// A [64, D] tile into padded shared memory by 16-byte cp.async (all 64 rows
// must exist).
template <int D>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                size_t row_stride) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < 64 * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst + r * (D + kPad) + c)),
                 "l"(src + r * row_stride + c));
  }
}

__device__ __forceinline__ float bf16_pair_sum(uint32_t u) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&u);
  return __low2float(v) + __high2float(v);
}

template <int VARIANT>
__global__ void __launch_bounds__(kThreads)
op_cost_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ rel,
               const int* __restrict__ lengths, float* __restrict__ out,
               float* __restrict__ out2, int S, int H, Geometry geo, float scale, Dropout dr) {
  constexpr int D = 64;
  constexpr int LD = D + kPad;
  constexpr int LDR = kVP + 1;
  constexpr bool kSwizzled = VARIANT == kWgmmaQk;
  constexpr bool kUsesV = VARIANT == kPv || VARIANT == kKtStore || VARIANT == kLdmatrixTrans;
  // q and k tiles: padded rows for mma.sync, 128-byte-swizzled rows (1024-byte
  // aligned) for wgmma; two k buffers for the cp.async ring.
  __shared__ __align__(1024) __nv_bfloat16 s_q[kSwizzled ? 64 * 64 : kBQ * LD];
  __shared__ __align__(1024) __nv_bfloat16
      s_k[kSwizzled ? 64 * 64 : (VARIANT == kCpAsync ? 2 : 1) * kBK * LD];
  __shared__ __align__(16) __nv_bfloat16 s_v[kUsesV ? D * (kBK + kPad) : 8];
  __shared__ float s_qr[kBQ * LDR];

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int L = max(0, min(lengths[b], S));
  const size_t row_stride = static_cast<size_t>(H) * D;
  const size_t head0 = static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(h) * D;
  float* out_bh = out + (static_cast<size_t>(b) * H + h) * S;
  const int r_lo = warp * 16 + g;  // this lane's rows: r_lo and r_lo + 8

  if (q0 >= L) {
    for (int r = threadIdx.x; r < kBQ; r += kThreads)
      if (q0 + r < S) out_bh[q0 + r] = 0.f;
    return;
  }

  const __nv_bfloat16* q_tile = q + head0 + static_cast<size_t>(q0) * row_stride;
  const __nv_bfloat16* rel_h = rel + static_cast<size_t>(h) * kVP * D;
  float acc[8][4];
  uint32_t qa[D / 16][4];
  if constexpr (kSwizzled) {
    load_tile_swizzled(s_q, q_tile, S - q0, row_stride);
    load_tile_swizzled(s_k, rel_h, kVP, D);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    wgmma_abt(acc, s_q, s_k);
  } else {
    load_tile<D>(s_q, q_tile, S - q0, row_stride);
    load_tile<D>(s_k, rel_h, kVP, D);
    __syncthreads();
    load_a_fragments<D>(qa, s_q, warp * 16 + g, t);
    matmul_abt<D>(acc, qa, s_k, g, t);
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {  // qr, read back only by this warp
    const int c = n * 8 + t * 2;
    s_qr[r_lo * LDR + c] = acc[n][0];
    s_qr[r_lo * LDR + c + 1] = acc[n][1];
    s_qr[(r_lo + 8) * LDR + c] = acc[n][2];
    s_qr[(r_lo + 8) * LDR + c + 1] = acc[n][3];
  }
  __syncwarp();

  const uint32_t seed_b = VARIANT == kHash ? example_seed(dr, b) : 0u;
  float rsum[2] = {0.f, 0.f};
  float m_run[2] = {-INFINITY, -INFINITY};  // kReduce, in the log2 domain
  float l_run[2] = {0.f, 0.f};
  float o_acc[D / 8][4];  // kPv
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) o_acc[nd][0] = o_acc[nd][1] = o_acc[nd][2] = o_acc[nd][3] = 0.f;

  const int num_tiles = (L + kBK - 1) / kBK;
  const __nv_bfloat16* k_head = k + head0;
  if constexpr (VARIANT == kCpAsync) {
    __syncthreads();  // R_h is no longer read
    load_tile_async<D>(s_k, k_head, row_stride);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int kt = 0; kt < num_tiles; ++kt) {
    const int k0 = kt * kBK;
    const __nv_bfloat16* k_tile = s_k;
    if constexpr (VARIANT == kCpAsync) {
      // Tile kt + 1 goes into the other buffer, which was last read in
      // iteration kt - 1 (the barrier at this loop's end).
      if (kt + 1 < num_tiles)
        load_tile_async<D>(s_k + ((kt + 1) & 1) * kBK * LD,
                           k_head + static_cast<size_t>(k0 + kBK) * row_stride, row_stride);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      __syncthreads();
      k_tile = s_k + (kt & 1) * kBK * LD;
    } else {
      __syncthreads();  // the previous tile (or R_h) is no longer read
      if constexpr (kSwizzled) {
        load_tile_swizzled(s_k, k_head + static_cast<size_t>(k0) * row_stride, S - k0,
                           row_stride);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      } else {
        load_tile<D>(s_k, k_head + static_cast<size_t>(k0) * row_stride, S - k0, row_stride);
      }
      const __nv_bfloat16* v_tile = v + head0 + static_cast<size_t>(k0) * row_stride;
      if constexpr (VARIANT == kPv || VARIANT == kKtStore)
        load_tile_transposed<D>(s_v, v_tile, S - k0, row_stride);
      if constexpr (VARIANT == kLdmatrixTrans) load_tile<D>(s_v, v_tile, S - k0, row_stride);
      __syncthreads();
    }

    if constexpr (kSwizzled) {
      wgmma_abt(acc, s_q, s_k);
    } else {
      matmul_abt<D>(acc, qa, k_tile, g, t);
    }

    float av[2] = {0.f, 0.f};
    if constexpr (VARIANT == kRank1) {
      const int id = k0 > q0 ? geo.text_max_distance : 2 * geo.text_max_distance;
      av[0] = s_qr[r_lo * LDR + id];
      av[1] = s_qr[(r_lo + 8) * LDR + id];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = r_lo + (e >> 1) * 8;
        const int i = q0 + rr;
        const int j = k0 + n * 8 + t * 2 + (e & 1);
        float x = acc[n][e];
        if constexpr (VARIANT == kIds) x += static_cast<float>(relative_id(i, j, geo));
        if constexpr (VARIANT == kGather) {
          const int id = relative_id(i, j, geo);
          if (id < geo.vocab) x += s_qr[rr * LDR + id];
        }
        if constexpr (VARIANT == kRank1) x += av[e >> 1];
        if constexpr (VARIANT == kMask) {
          if ((i < L) != (j < L)) x += kMaskBias;
        }
        if constexpr (VARIANT == kWindow) {
          if (!window_allowed(i, j, geo)) x += kMaskBias;
        }
        if constexpr (VARIANT == kHash) x *= dropout_keep(dr, seed_b, h, i, j);
        if constexpr (VARIANT == kExp) x = exp2f(x * (scale * kLog2e));
        if constexpr (VARIANT == kReduce) x *= scale * kLog2e;
        acc[n][e] = x;
        if constexpr (VARIANT != kReduce) rsum[e >> 1] += x;
      }
    }

    if constexpr (VARIANT == kReduce) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(acc[n][2 * hr], acc[n][2 * hr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[hr], mx);
        const float alpha = exp2f(m_run[hr] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          sum += exp2f(acc[n][2 * hr] - m_new);
          sum += exp2f(acc[n][2 * hr + 1] - m_new);
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l_run[hr] = l_run[hr] * alpha + sum;
        m_run[hr] = m_new;
      }
    }
    if constexpr (VARIANT == kPv) matmul_pb<D>(o_acc, acc, s_v, g, t);
    if constexpr (VARIANT == kKtStore) {
      // The B fragments matmul_pb reads: Vt rows nd * 8 + g, keys kc * 16 +
      // t * 2 + {0, 1, 8, 9}.
      constexpr int LDV = kBK + kPad;
      float fsum = 0.f;
#pragma unroll
      for (int kc = 0; kc < kBK / 16; ++kc) {
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          const __nv_bfloat16* p = s_v + (nd * 8 + g) * LDV + kc * 16 + t * 2;
          fsum += bf16_pair_sum(*reinterpret_cast<const uint32_t*>(p));
          fsum += bf16_pair_sum(*reinterpret_cast<const uint32_t*>(p + 8));
        }
      }
      rsum[0] += fsum;
      rsum[1] += fsum;
    }
    if constexpr (VARIANT == kLdmatrixTrans) {
      // The same fragments from the row-major tile: two transposed 8 x 8
      // matrices (keys kc * 16 + [0, 8) and + [8, 16), columns nd * 8 + [0, 8)).
      float fsum = 0.f;
#pragma unroll
      for (int kc = 0; kc < kBK / 16; ++kc) {
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          uint32_t b0, b1;
          const uint32_t addr = smem_u32(s_v + (kc * 16 + (lane & 15)) * LD + nd * 8);
          asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                       : "=r"(b0), "=r"(b1)
                       : "r"(addr));
          fsum += bf16_pair_sum(b0) + bf16_pair_sum(b1);
        }
      }
      rsum[0] += fsum;
      rsum[1] += fsum;
    }
    if constexpr (VARIANT == kCpAsync) __syncthreads();  // this buffer is refilled next
  }

  if constexpr (VARIANT == kAtomics) {
    float* dst = out2 + (static_cast<size_t>(b) * H + h) * kVP * D;
    for (int idx = threadIdx.x; idx < 49 * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      atomicAdd(dst + idx, __bfloat162float(s_q[r * LD + c]));
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float total = rsum[hr];
    if constexpr (VARIANT == kPv) {
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) total += o_acc[nd][2 * hr] + o_acc[nd][2 * hr + 1];
    }
    total += __shfl_xor_sync(0xffffffffu, total, 1);
    total += __shfl_xor_sync(0xffffffffu, total, 2);
    if constexpr (VARIANT == kReduce) total = (m_run[hr] + log2f(l_run[hr])) * kLn2;
    const int i = q0 + r_lo + hr * 8;
    if (t == 0 && i < S) out_bh[i] = total + s_qr[(r_lo + hr * 8) * LDR];
  }
}

template <int VARIANT>
void launch(dim3 grid, cudaStream_t s, const __nv_bfloat16* q, const __nv_bfloat16* k,
            const __nv_bfloat16* v, const __nv_bfloat16* rel, const int* lengths, float* out,
            float* out2, int S, int H, const Geometry& geo, float scale, const Dropout& dr) {
  op_cost_kernel<VARIANT><<<grid, kThreads, 0, s>>>(q, k, v, rel, lengths, out, out2, S, H, geo,
                                                    scale, dr);
}

using LaunchFn = decltype(&launch<kBase>);

template <int... Vs>
LaunchFn pick(int variant, std::integer_sequence<int, Vs...>) {
  static constexpr LaunchFn table[] = {launch<Vs>...};
  return table[variant];
}

}  // namespace

// q, k, v: bf16 [B, S, H, 64] contiguous, S a multiple of 64; rel: bf16
// [H, 64, 64] contiguous (rows >= V zero); lengths: int32 [B]; out: fp32
// [B, H, S]; out2: fp32 [B, H, 64, 64], zeroed by the caller (written by
// the atomics variant only).  `variant` indexes Variant above.  window /
// num_global are read by the window variant, the dropout arguments by the
// hash variant.  Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int mmt_probe_op_cost(const void* q, const void* k, const void* v, const void* rel,
                                 const void* lengths, void* out, void* out2, int variant,
                                 int batch, int seq_len, int num_heads, int head_dim, int vocab,
                                 int image_len, int patch_per_row, int core_layers,
                                 int text_max_distance, int image_part_id, int text_part_id,
                                 int window, int num_global, float scale, int dropout_threshold,
                                 float keep_scale, int seed, void* stream) {
  if (variant < 0 || variant >= kNumVariants || head_dim != 64 || seq_len % 64 != 0 ||
      vocab < 1 || vocab > kVP || rel == nullptr || 2 * text_max_distance >= vocab)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry geo{image_len,     patch_per_row, core_layers, text_max_distance,
                     image_part_id, text_part_id,  vocab,       window, num_global};
  const Dropout dr{static_cast<uint32_t>(dropout_threshold), keep_scale,
                   static_cast<uint32_t>(seed), 0u};
  const dim3 grid(seq_len / kBQ, num_heads, batch);
  const LaunchFn fn = pick(variant, std::make_integer_sequence<int, kNumVariants>{});
  fn(grid, static_cast<cudaStream_t>(stream), static_cast<const __nv_bfloat16*>(q),
     static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
     static_cast<const __nv_bfloat16*>(rel), static_cast<const int*>(lengths),
     static_cast<float*>(out), static_cast<float*>(out2), seq_len, num_heads, geo, scale, dr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mmt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
