// Y(M, N) = X(M, K) . W with W stored in the paper's bitmap format.
//
// Replaces the TPU kernel src/repro/kernels/bitmap_spmm.py:bitmap_spmm
// (Pallas: `_kernel`, `_decompress_tile`).  W is tiled (BK, BN); per tile
// it holds the packed bitmap (BK rows of BN/8 bytes, little-endian within
// a byte), the non-zero values packed row by row into `budget` slots, and
// one start slot per row.  An element's value sits at
// row_start[row] + rank, rank = set bits before it in its row (the EIM
// re-sort).  Values are rounded to X's type before the product, as the
// reference casts its decompressed tile; sums are kept in float32.
//
// What bounds it: at decode M (1..8 rows) every weight byte feeds at most
// eight multiply-adds, far below the ~295 operations per byte where the
// H100 stops being bound by its memory, so the kernel is bound by the
// compressed weight bytes it streams (values + bitmap + row starts).
// What the design does about it:
// * each weight byte is read from device memory once per 8 rows of X;
// * a tile's values (the bulk of the stream), row starts and bitmap are
//   copied to shared memory with cp.async, all of a tile's loads in
//   flight at once, double-buffered: the next tile streams in while the
//   current one is computed; the EIM lookups then read shared memory;
// * K is split across blocks so that the 2048-wide outputs of a decode
//   step still fill the card (16 column tiles alone would use 16 of 132
//   SMs); each split writes float32 partial sums and a second kernel adds
//   them in a fixed order, so results do not depend on scheduling.
// Rows of a tile are spread over the 8 warps of a block and summed across
// warps at the end.  Not done yet: TMA, and fewer wasted multiply-adds
// when M < 8.
//
// Grid: (N / BN, splits of K, G x ceil(M / 8)).  Any M >= 1: the ragged
// last row block is masked, with no padding of X.
//
// The grouped form (bitmap_spmm_grouped_launch) computes Y[g] = X[g] . W_g
// for a group-stacked W (MoE expert stacks: G experts, one shared value
// budget, so every group's leaves have the same stride).  It replaces
// src/repro/kernels/bitmap_spmm.py:bitmap_spmm_grouped, which unrolls G
// calls of the TPU kernel.  Here the group is folded into grid z (z = g x
// row blocks + row block) and each block offsets its pointers by g, so one
// launch keeps every group's tiles in flight; split-K counts all G x N/BN
// x row-block blocks when sizing the split.  Bound, as for one matrix: the
// compressed weight bytes at decode M.  K1 is the case G = 1.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsM = 8;                  // rows of X per block
constexpr int kMaxBK = 128;
constexpr int kMaxBN = 128;
constexpr int kRowBytes = kMaxBN / 8;      // one bitmap row, zero padded
constexpr int kWords = kRowBytes / 4;      // column lane + 32*j is bit lane of word j
constexpr int kRedBytes = kWarps * kRowsM * kMaxBN * 4;
constexpr int kMaxDynBytes = 2 * kMaxBK * kMaxBN * 4;  // two dense float32 tiles

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Stage one K tile into shared memory (vs, bits_s, rs_s): float32 values,
// row starts and, for word-aligned bitmap rows (BN % 32 == 0), the bitmap
// by cp.async, left in flight for the caller to commit and wait on; the
// rest loads through registers.  Bitmap rows are zero-padded to kRowBytes.
template <typename VT>
__device__ __forceinline__ void stage_tile(
    VT* vs, uint8_t* bits_s, int32_t* rs_s, const uint8_t* __restrict__ bits,
    const VT* __restrict__ values, const int32_t* __restrict__ row_start,
    size_t tile, int bk, int bn, int budget, int tid) {
  const VT* vsrc = values + tile * budget;
  if constexpr (sizeof(VT) == 4) {
    // float32 values: every tile starts on a 4-byte boundary
    for (int i = tid; i < budget; i += kThreads)
      __pipeline_memcpy_async(vs + i, vsrc + i, 4);
  } else {
    for (int i = tid; i < budget; i += kThreads) vs[i] = vsrc[i];
  }
  for (int i = tid; i < bk; i += kThreads)
    __pipeline_memcpy_async(rs_s + i, row_start + tile * bk + i, 4);
  const int row_bytes = bn / 8;
  const uint8_t* bsrc = bits + tile * bk * row_bytes;
  if (row_bytes % 4 == 0 && (reinterpret_cast<uintptr_t>(bsrc) & 3u) == 0) {
    const int row_words = row_bytes / 4;
    for (int e = tid; e < bk * kWords; e += kThreads) {
      const int r = e / kWords, w = e % kWords;
      uint32_t* dst = reinterpret_cast<uint32_t*>(bits_s + r * kRowBytes) + w;
      if (w < row_words)
        __pipeline_memcpy_async(dst, bsrc + (r * row_words + w) * 4, 4);
      else
        *dst = 0u;
    }
  } else {
    for (int e = tid; e < bk * kRowBytes; e += kThreads) {
      const int r = e / kRowBytes, b = e % kRowBytes;
      bits_s[e] = b < row_bytes ? bsrc[r * row_bytes + b] : uint8_t(0);
    }
  }
}

// Dynamic shared memory holds two tiles' values (double buffer), and at
// the end the per-warp partial sums; the launch sizes it
// max(2 x values, kRedBytes).
template <typename XT, typename VT, typename OT>
__global__ void __launch_bounds__(kThreads, 2)
bitmap_spmm_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ bits,
                   const VT* __restrict__ values,
                   const int32_t* __restrict__ row_start,
                   OT* __restrict__ out, float* __restrict__ partial, int m,
                   int kt_count, int nt_count, int bk, int bn, int budget,
                   int tiles_per_split, int stage_elems, int row_blocks,
                   int groups) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ float xs[2][kRowsM][kMaxBK];
  __shared__ __align__(16) uint8_t bits_s[2][kMaxBK * kRowBytes];
  __shared__ int32_t rs_s[2][kMaxBK];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nt = blockIdx.x;
  const int split = blockIdx.y;
  const int g = blockIdx.z / row_blocks;
  const int m0 = (blockIdx.z % row_blocks) * kRowsM;
  const int k = kt_count * bk;
  const int n = nt_count * bn;
  // this block's group: every group's leaves have the same stride
  const size_t tiles = static_cast<size_t>(kt_count) * nt_count;
  x += static_cast<size_t>(g) * m * k;
  bits += static_cast<size_t>(g) * tiles * bk * (bn / 8);
  values += static_cast<size_t>(g) * tiles * budget;
  row_start += static_cast<size_t>(g) * tiles * bk;
  out += static_cast<size_t>(g) * m * n;
  const uint32_t lanes_below = (1u << lane) - 1u;
  const int kt0 = split * tiles_per_split;
  const int kt1 = min(kt0 + tiles_per_split, kt_count);
  VT* vbuf[2] = {reinterpret_cast<VT*>(dyn),
                 reinterpret_cast<VT*>(dyn) + stage_elems};

  // this thread's share of a tile of X, fetched one tile ahead
  constexpr int kXPerThread = kRowsM * kMaxBK / kThreads;
  float x_next[kXPerThread];
  auto fetch_x = [&](int kt) {
#pragma unroll
    for (int i = 0; i < kXPerThread; ++i) {
      const int e = tid + i * kThreads;
      const int mi = e / kMaxBK, kk = e % kMaxBK;
      x_next[i] = (kk < bk && m0 + mi < m)
                      ? to_f32<XT>(x[static_cast<size_t>(m0 + mi) * k +
                                     kt * bk + kk])
                      : 0.f;
    }
  };
  auto store_x = [&](int s) {
#pragma unroll
    for (int i = 0; i < kXPerThread; ++i) {
      const int e = tid + i * kThreads;
      xs[s][e / kMaxBK][e % kMaxBK] = x_next[i];
    }
  };

  float acc[kRowsM][kWords];
#pragma unroll
  for (int i = 0; i < kRowsM; ++i)
#pragma unroll
    for (int j = 0; j < kWords; ++j) acc[i][j] = 0.f;

  stage_tile<VT>(vbuf[0], bits_s[0], rs_s[0], bits, values, row_start,
                 static_cast<size_t>(kt0) * nt_count + nt, bk, bn, budget, tid);
  __pipeline_commit();
  fetch_x(kt0);
  store_x(0);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int s = (kt - kt0) & 1;
    const bool more = kt + 1 < kt1;
    if (more) {
      // the next tile streams in while this one is computed
      stage_tile<VT>(vbuf[s ^ 1], bits_s[s ^ 1], rs_s[s ^ 1], bits, values,
                     row_start, static_cast<size_t>(kt + 1) * nt_count + nt,
                     bk, bn, budget, tid);
      __pipeline_commit();
      fetch_x(kt + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();

    const VT* vs = vbuf[s];
    for (int r = warp; r < bk; r += kWarps) {
      const uint32_t* wr =
          reinterpret_cast<const uint32_t*>(bits_s[s] + r * kRowBytes);
      float xk[kRowsM];
#pragma unroll
      for (int i = 0; i < kRowsM; ++i) xk[i] = xs[s][i][r];
      int before = rs_s[s][r];
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        const uint32_t w = wr[j];
        if ((w >> lane) & 1u) {
          int slot = before + __popc(w & lanes_below);
          slot = min(max(slot, 0), budget - 1);
          const float v = to_f32<XT>(from_f32<XT>(to_f32<VT>(vs[slot])));
#pragma unroll
          for (int i = 0; i < kRowsM; ++i) acc[i][j] = fmaf(xk[i], v, acc[i][j]);
        }
        before += __popc(w);
      }
    }
    if (more) store_x(s ^ 1);
    __syncthreads();  // stage s is free for the tile after next
  }

  float* red = reinterpret_cast<float*>(dyn);  // [kWarps][kRowsM][kMaxBN]
#pragma unroll
  for (int i = 0; i < kRowsM; ++i)
#pragma unroll
    for (int j = 0; j < kWords; ++j)
      red[(warp * kRowsM + i) * kMaxBN + lane + 32 * j] = acc[i][j];
  __syncthreads();
  for (int e = tid; e < kRowsM * bn; e += kThreads) {
    const int i = e / bn, c = e % bn;
    if (m0 + i >= m) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[(w * kRowsM + i) * kMaxBN + c];
    const size_t at = static_cast<size_t>(m0 + i) * n +
                      static_cast<size_t>(nt) * bn + c;
    if (partial != nullptr)   // (splits, G, M, N)
      partial[(static_cast<size_t>(split) * groups + g) * m * n + at] = s;
    else
      out[at] = from_f32<OT>(s);
  }
}

// out = sum over splits of the float32 partial products, in split order.
template <typename OT>
__global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  OT* __restrict__ out, int splits,
                                  size_t count) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += partial[p * count + i];
  out[i] = from_f32<OT>(s);
}

template <typename XT, typename VT, typename OT>
int launch(const void* x, const void* bits, const void* values,
           const void* row_start, void* out, void* partial, int groups,
           int m, int kt, int nt, int bk, int bn, int budget, int splits,
           cudaStream_t stream) {
  auto kernel = bitmap_spmm_kernel<XT, VT, OT>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynBytes);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const int per = (kt + splits - 1) / splits;
  const int used = (kt + per - 1) / per;  // no split is left empty
  // each stage starts 16-byte aligned
  const int stage_elems = (budget * static_cast<int>(sizeof(VT)) + 15) / 16 *
                          16 / static_cast<int>(sizeof(VT));
  const int vbytes = 2 * stage_elems * static_cast<int>(sizeof(VT));
  const int dyn = vbytes > kRedBytes ? vbytes : kRedBytes;
  const int row_blocks = (m + kRowsM - 1) / kRowsM;
  const dim3 grid(nt, used, groups * row_blocks);
  float* part = used > 1 ? static_cast<float*>(partial) : nullptr;
  kernel<<<grid, kThreads, dyn, stream>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(bits),
      static_cast<const VT*>(values), static_cast<const int32_t*>(row_start),
      static_cast<OT*>(out), part, m, kt, nt, bk, bn, budget, per,
      stage_elems, row_blocks, groups);
  if (used > 1) {
    const size_t count = static_cast<size_t>(groups) * m * nt * bn;
    const int threads = 256;
    const unsigned blocks = static_cast<unsigned>((count + threads - 1) / threads);
    sum_splits_kernel<OT><<<blocks, threads, 0, stream>>>(
        part, static_cast<OT*>(out), used, count);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, typename VT>
int launch_out(int o_bf16, const void* x, const void* bits, const void* values,
               const void* row_start, void* out, void* partial, int groups,
               int m, int kt, int nt, int bk, int bn, int budget, int splits,
               cudaStream_t stream) {
  return o_bf16 ? launch<XT, VT, __nv_bfloat16>(x, bits, values, row_start, out,
                                                partial, groups, m, kt, nt, bk,
                                                bn, budget, splits, stream)
                : launch<XT, VT, float>(x, bits, values, row_start, out,
                                        partial, groups, m, kt, nt, bk, bn,
                                        budget, splits, stream);
}

int dispatch(const void* x, const void* bits, const void* values,
             const void* row_start, void* out, void* partial, int groups,
             int m, int kt, int nt, int bk, int bn, int budget, int splits,
             int x_bf16, int v_bf16, int o_bf16, void* stream) {
  const long long row_blocks = (m + kRowsM - 1) / kRowsM;
  if (groups < 1 || m < 1 || kt < 1 || nt < 1 || bk < 1 || bk > kMaxBK ||
      bn < 8 || bn > kMaxBN || bn % 8 != 0 || budget < 1 ||
      budget > kMaxBK * kMaxBN || splits < 1 ||
      (splits > 1 && partial == nullptr) || groups * row_blocks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return v_bf16 ? launch_out<__nv_bfloat16, __nv_bfloat16>(
                        o_bf16, x, bits, values, row_start, out, partial,
                        groups, m, kt, nt, bk, bn, budget, splits, s)
                  : launch_out<__nv_bfloat16, float>(
                        o_bf16, x, bits, values, row_start, out, partial,
                        groups, m, kt, nt, bk, bn, budget, splits, s);
  }
  return v_bf16 ? launch_out<float, __nv_bfloat16>(o_bf16, x, bits, values,
                                                   row_start, out, partial,
                                                   groups, m, kt, nt, bk, bn,
                                                   budget, splits, s)
                : launch_out<float, float>(o_bf16, x, bits, values, row_start,
                                           out, partial, groups, m, kt, nt, bk,
                                           bn, budget, splits, s);
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Type flags: 0 = float32,
// 1 = bfloat16.  `splits` > 1 splits K over that many blocks per column
// tile (fewer if the K tiles do not divide evenly); `partial` is then a
// float32 scratch buffer of splits x G x M x N.  Each returns the launches'
// cudaGetLastError() (0 = success).
extern "C" int bitmap_spmm_launch(const void* x, const void* bits,
                                  const void* values, const void* row_start,
                                  void* out, void* partial, int m, int kt,
                                  int nt, int bk, int bn, int budget,
                                  int splits, int x_bf16, int v_bf16,
                                  int o_bf16, void* stream) {
  return dispatch(x, bits, values, row_start, out, partial, 1, m, kt, nt, bk,
                  bn, budget, splits, x_bf16, v_bf16, o_bf16, stream);
}

// Y[g] = X[g] . W_g for g < groups: X (G, M, K), Y (G, M, N), the weight's
// leaves (G, KT, NT, ...) with one budget for the whole stack.
extern "C" int bitmap_spmm_grouped_launch(
    const void* x, const void* bits, const void* values, const void* row_start,
    void* out, void* partial, int groups, int m, int kt, int nt, int bk,
    int bn, int budget, int splits, int x_bf16, int v_bf16, int o_bf16,
    void* stream) {
  return dispatch(x, bits, values, row_start, out, partial, groups, m, kt, nt,
                  bk, bn, budget, splits, x_bf16, v_bf16, o_bf16, stream);
}
