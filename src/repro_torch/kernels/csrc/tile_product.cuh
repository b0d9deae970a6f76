// Shared pieces of the dense-X x sparse-W tile products (block_sparse.cu,
// nm_spmm.cu): one block of 256 threads owns an output tile of RM rows x
// BN columns (BN <= 128, BN % 32 == 0) and walks the K tiles the weight
// keeps, each staged in shared memory as float32:
//   xs[kk * XS + r]   the X tile, transposed (BK x RM, row stride XS)
//   ws[kk * BN + c]   the weight tile (BK x BN), rounded to X's type
// Warps are laid out WR along rows (8 rows each) by WK = 8 / WR along the
// K tile: at decode M (WR = 1) all eight warps share the same 8 rows and
// take every eighth row of the K tile, and their sums are added in a
// fixed order at the end.  Lane l owns columns l + 32 j.  Sums are kept in
// float32.  Everything here has internal linkage: each source that
// includes it keeps its own copy of the kernels.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {
namespace tile {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBK = 128;
constexpr int kMaxBN = 128;
constexpr int kMaxCJ = kMaxBN / 32;

template <int WR>
struct Shape {
  static_assert(WR == 1 || WR == kWarps, "warps lie all along K or all along M");
  static constexpr int RM = 8 * WR;        // output rows per block
  static constexpr int WK = kWarps / WR;   // warps sharing one K tile
  static constexpr int XS = RM + 4;        // xs row stride (floats)
};

// The row tiles an entry point takes; the wrapper picks one per call
// (kernels/tile_product.py: row_tile).
inline bool valid_rows(int rows) {
  return rows == Shape<1>::RM || rows == Shape<kWarps>::RM;
}

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

// v rounded to T and back: the weight takes X's type before the product,
// as the plain versions cast the dense weight to x.dtype.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// Dynamic shared memory of one block: xs, then ws (reused at the end for
// the per-warp sums when WK > 1).
template <int WR>
__host__ __device__ constexpr int smem_bytes(int bk, int bn) {
  const int ws = bk * bn;
  const int red = Shape<WR>::WK > 1 ? Shape<WR>::WK * 8 * bn : 0;
  return 4 * (bk * Shape<WR>::XS + (ws > red ? ws : red));
}

// X rows m0.. (RM of them, zero past m), columns k0 .. k0 + bk, into xs.
// Each thread starts U loads before it stores any, so that they are in
// flight together.
template <typename XT, int WR>
__device__ __forceinline__ void stage_x(float* xs, const XT* __restrict__ x,
                                        int m, int k, int m0, int k0, int bk,
                                        int tid) {
  constexpr int RM = Shape<WR>::RM, XS = Shape<WR>::XS, U = 8;
  for (int base = 0; base < RM * bk; base += kThreads * U) {
    float r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + u * kThreads + tid;
      const int row = m0 + e / bk;
      r[u] = e < RM * bk && row < m
                 ? to_f32<XT>(x[static_cast<size_t>(row) * k + k0 + e % bk])
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + u * kThreads + tid;
      if (e < RM * bk) xs[(e % bk) * XS + e / bk] = r[u];
    }
  }
}

// Sixteen bytes of T as floats: 4 float32 or 8 bfloat16 values.
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& u, float* f);
template <>
__device__ __forceinline__ void unpack16<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& u,
                                                        float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // element 2i sits in the low half
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// ws[e] = src[e] rounded to XT, e < count: a dense weight tile, read as
// 16-byte loads (count a multiple of 16 / sizeof(VT), src 16-byte
// aligned), U of them in flight per thread.
template <typename XT, typename VT>
__device__ __forceinline__ void stage_w(float* ws, const VT* __restrict__ src,
                                        int count, int tid) {
  constexpr int V = 16 / sizeof(VT), U = 4;
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  const int n4 = count / V;
  for (int base = 0; base < n4; base += kThreads * U) {
    uint4 r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + u * kThreads + tid;
      r[u] = e < n4 ? __ldg(s4 + e) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + u * kThreads + tid;
      if (e >= n4) continue;
      float f[V];
      unpack16<VT>(r[u], f);
#pragma unroll
      for (int i = 0; i < V; i += 4)
        *reinterpret_cast<float4*>(ws + e * V + i) =
            make_float4(round_to<XT>(f[i]), round_to<XT>(f[i + 1]),
                        round_to<XT>(f[i + 2]), round_to<XT>(f[i + 3]));
    }
  }
}

// acc[i][j] += sum over this warp's rows kk of the K tile of
// xs[kk][row i] * ws[kk][lane + 32 j].
template <int WR>
__device__ __forceinline__ void mac(float (&acc)[8][kMaxCJ],
                                    const float* xs, const float* ws, int bk,
                                    int bn, int warp, int lane) {
  constexpr int XS = Shape<WR>::XS, WK = Shape<WR>::WK;
  const int r0 = (warp % WR) * 8;
  const int cj = bn / 32;
  for (int kk = warp / WR; kk < bk; kk += WK) {
    const float4 a = *reinterpret_cast<const float4*>(xs + kk * XS + r0);
    const float4 b = *reinterpret_cast<const float4*>(xs + kk * XS + r0 + 4);
    const float xr[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int j = 0; j < kMaxCJ; ++j) {
      if (j < cj) {
        const float w = ws[kk * bn + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(xr[i], w, acc[i][j]);
      }
    }
  }
}

// The block's sums into out (M, N) at columns n0.., or, with `partial`,
// into split `split` of the float32 partial sums (splits, M, N).  When
// WK > 1 the warps sharing rows are added in warp order through `red`
// (the ws region; the caller has synchronised after its last mac).
template <int WR, typename OT>
__device__ __forceinline__ void store(const float (&acc)[8][kMaxCJ],
                                      float* red, OT* __restrict__ out,
                                      float* __restrict__ partial, int split,
                                      int m, int n, int m0, int n0, int bn,
                                      int warp, int lane, int tid) {
  constexpr int WK = Shape<WR>::WK, RM = Shape<WR>::RM;
  const int cj = bn / 32;
  auto put = [&](int row, int c, float s) {
    if (row >= m) return;
    const size_t at = static_cast<size_t>(row) * n + n0 + c;
    if (partial != nullptr)
      partial[static_cast<size_t>(split) * m * n + at] = s;
    else
      out[at] = from_f32<OT>(s);
  };
  if constexpr (WK == 1) {
    const int r0 = warp * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < kMaxCJ; ++j)
        if (j < cj) put(m0 + r0 + i, lane + 32 * j, acc[i][j]);
  } else {
    // WR == 1: every warp holds the same 8 rows; red[(warp * 8 + i) * bn + c]
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < kMaxCJ; ++j)
        if (j < cj) red[(warp * 8 + i) * bn + lane + 32 * j] = acc[i][j];
    __syncthreads();
    for (int e = tid; e < RM * bn; e += kThreads) {
      const int i = e / bn, c = e % bn;
      float s = 0.f;
      for (int w = 0; w < WK; ++w) s += red[(w * 8 + i) * bn + c];
      put(m0 + i, c, s);
    }
  }
}

// out = sum over splits of the float32 partial sums, in split order.
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

template <typename OT>
inline void sum_splits(const float* partial, void* out, int splits,
                       size_t count, cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((count + threads - 1) / threads);
  sum_splits_kernel<OT><<<blocks, threads, 0, stream>>>(
      partial, static_cast<OT*>(out), splits, count);
}

}  // namespace tile
}  // namespace
