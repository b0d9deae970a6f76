// O = softmax(Q K^T / sqrt(D) + mask) V per (batch, query head), with
// grouped-query heads, causal and sliding-window masks, by online softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (Pallas: `_kernel`).  Its semantics, kept exactly:
// query head h reads KV head h / (Hq / Hkv); scores are float32 products
// of the inputs in their own type, times D^-0.5; a score is masked when
// causal and q_pos < k_pos, or with a window when q_pos - k_pos >= window
// (positions from 0, top-left aligned), and a masked score is -1e30, not
// -inf; m, l and the accumulator are float32, p is rounded to V's type
// before the PV product (l sums the float32 p); the output is
// acc / max(l, 1e-30) in Q's type.
//
// Design: one block of 256 threads per (batch x query head, tile of BQ
// query rows); a loop inside the block over KV tiles of BKV rows takes the
// place of the TPU grid's sequential axis.  The Q tile stays in shared
// memory; each K and V tile is copied there with cp.async, K of the next
// tile streaming in while the current PV product runs and V while the
// next scores run.  Scores: thread (r, c) of a 16 x 16 grid holds BQ/16
// rows x BKV/16 columns, row maxima and sums by shuffles within its 16
// lanes.  PV: warp w holds BQ/8 rows, lane l the columns l + 32 j.  BQ =
// BKV = 64, except 32 for D = 256 (whose float32 accumulator would not
// fit).  Any Sq and Skv: rows past Sq are not stored, and key columns past
// Skv are -inf (they are not keys at all, so they weigh exactly 0).
//
// Skipped KV tiles: a tile lying wholly above the causal diagonal or
// wholly outside the window of every row of the query tile is not read.
// This is exact: a fully masked tile seen before any live score of a row
// adds terms that alpha = exp(-1e30 - m) zeroes once the first live score
// sets m, and one seen after adds exp(-1e30 - m) = 0.  It is not exact
// for a row with no live key at all (a window with Sq >= Skv + window),
// whose reference output is the mean of V over every masked key; a query
// tile holding such a row walks every KV tile.
//
// What bounds it on the H100: at these shapes operations (4 x D per live
// score pair), far above the bytes of Q, K, V and O; this kernel uses the
// FMA units, not the tensor cores, so it stays far from the card's bf16
// peak.  What the design does about it: each K/V tile is read from device
// memory once per query tile and reused by all BQ rows; the masked
// tiles are skipped; the heaviest query tiles (most live KV tiles under a
// causal mask) are scheduled first.  Not done yet: mma / wgmma, TMA, warp
// specialisation.

#include <cmath>
#include <cstdint>

#include <cuda_pipeline.h>

#include "tile_product.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kMasked = -1e30f;

template <typename T, int D, int BQ, int BKV>
struct Fa {
  static constexpr int V = 16 / sizeof(T);   // elements in one 16-byte chunk
  static constexpr int RS = D + V;           // q/k/v tile row stride: 16 bytes of padding
  static constexpr int RPT = BQ / 16;        // scores: rows per thread
  static constexpr int CPT = BKV / 16;       // scores: columns per thread
  static constexpr int RW = BQ / 8;          // PV: rows per warp
  static constexpr int DJ = D / 32;          // PV: columns per lane
  static constexpr int PS = BKV + 4;         // p tile row stride (floats)
  static constexpr int bytes = static_cast<int>(sizeof(T)) * RS * (BQ + 2 * BKV) +
                               4 * (BQ * PS + 2 * BQ);
  static_assert(D % 32 == 0 && BQ % 16 == 0 && BKV % 16 == 0, "tile shape");
};

// Rows row0 .. row0 + rows of a (total, D) matrix into dst (row stride RS)
// with 16-byte cp.async copies, left in flight; rows past `total` are
// zeroed.
template <typename T, int D, int RS>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src,
                                           int row0, int rows, int total,
                                           int tid) {
  constexpr int V = 16 / sizeof(T), CH = D / V;
  for (int e = tid; e < rows * CH; e += kThreads) {
    const int r = e / CH, c = e % CH;
    T* d = dst + r * RS + c * V;
    if (row0 + r < total)
      __pipeline_memcpy_async(d, src + static_cast<size_t>(row0 + r) * D + c * V,
                              16);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename T, int D, int BQ, int BKV>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int hq,
                       int hkv, int sq, int skv, int causal, int window,
                       float scale) {
  using F = Fa<T, D, BQ, BKV>;
  constexpr int V = F::V, RS = F::RS, RPT = F::RPT, CPT = F::CPT;
  constexpr int RW = F::RW, DJ = F::DJ, PS = F::PS;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + BQ * RS;
  T* vs = ks + BKV * RS;
  float* ps = reinterpret_cast<float*>(vs + BKV * RS);
  float* alpha_s = ps + BQ * PS;
  float* l_s = alpha_s + BQ;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest tiles first
  const int bh = blockIdx.y;
  const int kvh = (bh % hq) / (hq / hkv);
  q += static_cast<size_t>(bh) * sq * D;
  out += static_cast<size_t>(bh) * sq * D;
  const size_t kv_off = (static_cast<size_t>(bh / hq) * hkv + kvh) * skv * D;
  k += kv_off;
  v += kv_off;

  const int n_kv = (skv + BKV - 1) / BKV;
  const int q_last = min(q0 + BQ, sq) - 1;
  int t0 = 0, t1 = n_kv;
  if (window <= 0 || static_cast<long long>(q_last) <
                         static_cast<long long>(skv) - 1 + window) {
    // every row of the tile has a live key: skipping is exact
    if (causal) t1 = min(n_kv, q_last / BKV + 1);
    if (window > 0) t0 = max(0, q0 - window + 1) / BKV;
  }

  stage_rows<T, D, RS>(qs, q, q0, BQ, sq, tid);
  stage_rows<T, D, RS>(ks, k, t0 * BKV, BKV, skv, tid);
  __pipeline_commit();
  stage_rows<T, D, RS>(vs, v, t0 * BKV, BKV, skv, tid);
  __pipeline_commit();

  const int sr = tid / 16, sc = tid % 16;   // scores: rows sr*RPT + i, cols sc + 16 j
  float m_i[RPT], l_i[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m_i[i] = kMasked;
    l_i[i] = 0.f;
  }
  float acc[RW][DJ];                        // PV: rows warp*RW + i, cols lane + 32 j
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int t = t0; t < t1; ++t) {
    __pipeline_wait_prior(1);   // Q and K(t) have landed; V(t) may not have
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; d += V) {
      float qf[RPT][V], kf[CPT][V];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        tile::unpack16<T>(
            *reinterpret_cast<const uint4*>(qs + (sr * RPT + i) * RS + d), qf[i]);
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        tile::unpack16<T>(
            *reinterpret_cast<const uint4*>(ks + (sc + 16 * j) * RS + d), kf[j]);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j)
#pragma unroll
          for (int e = 0; e < V; ++e) s[i][j] = fmaf(qf[i][e], kf[j][e], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = sr * RPT + i, qp = q0 + row;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kp = t * BKV + sc + 16 * j;
        float val = s[i][j] * scale;
        if (kp >= skv)
          val = -INFINITY;
        else if ((causal && qp < kp) || (window > 0 && qp - kp >= window))
          val = kMasked;
        s[i][j] = val;
        mx = fmaxf(mx, val);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[row * PS + sc + 16 * j] = tile::round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m_i[i] - m_new);
      l_i[i] = alpha * l_i[i] + sum;
      m_i[i] = m_new;
      if (sc == 0) alpha_s[row] = alpha;
    }
    __syncthreads();   // K(t) is free; p and alpha are ready
    if (t + 1 < t1) stage_rows<T, D, RS>(ks, k, (t + 1) * BKV, BKV, skv, tid);
    __pipeline_commit();
    __pipeline_wait_prior(1);   // V(t) has landed
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const float a = alpha_s[warp * RW + i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= a;
    }
    for (int c = 0; c < BKV; c += 4) {
      float pr[RW][4];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(ps + (warp * RW + i) * PS + c);
        pr[i][0] = p4.x;
        pr[i][1] = p4.y;
        pr[i][2] = p4.z;
        pr[i][3] = p4.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[DJ];
#pragma unroll
        for (int j = 0; j < DJ; ++j)
          vv[j] = tile::to_f32<T>(vs[(c + cc) * RS + lane + 32 * j]);
#pragma unroll
        for (int i = 0; i < RW; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pr[i][cc], vv[j], acc[i][j]);
      }
    }
    __syncthreads();   // V(t) is free
    if (t + 1 < t1) stage_rows<T, D, RS>(vs, v, (t + 1) * BKV, BKV, skv, tid);
    __pipeline_commit();
  }
  __pipeline_wait_prior(0);

  if (sc == 0) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) l_s[sr * RPT + i] = l_i[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int row = warp * RW + i;
    if (q0 + row >= sq) continue;
    const float l = fmaxf(l_s[row], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      out[static_cast<size_t>(q0 + row) * D + lane + 32 * j] =
          tile::from_f32<T>(acc[i][j] / l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int hq, int hkv, int sq, int skv, int causal, int window,
           float scale, cudaStream_t stream) {
  constexpr int BQ = D == 256 ? 32 : 64, BKV = BQ;
  using F = Fa<T, D, BQ, BKV>;
  auto kernel = flash_attention_kernel<T, D, BQ, BKV>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F::bytes);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const dim3 grid((sq + BQ - 1) / BQ, b * hq);
  kernel<<<grid, kThreads, F::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, hkv, sq, skv,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* out,
             int b, int hq, int hkv, int sq, int skv, int causal, int window,
             float scale, cudaStream_t s) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, out, b, hq, hkv, sq, skv, causal, window,
                           scale, s);
    case 64:
      return launch<T, 64>(q, k, v, out, b, hq, hkv, sq, skv, causal, window,
                           scale, s);
    case 128:
      return launch<T, 128>(q, k, v, out, b, hq, hkv, sq, skv, causal, window,
                            scale, s);
    case 256:
      return launch<T, 256>(q, k, v, out, b, hq, hkv, sq, skv, causal, window,
                            scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  q, out (B, Hq, Sq, D) and k, v
// (B, Hkv, Skv, D), contiguous, 16-byte aligned, all float32 (bf16 = 0) or
// all bfloat16 (bf16 = 1); D in {32, 64, 128, 256}; window <= 0 means no
// window.  Returns the launch's cudaGetLastError() (0 = success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int b, int hq,
                                      int hkv, int sq, int skv, int d,
                                      int causal, int window, float scale,
                                      int bf16, void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || skv < 1 ||
      static_cast<long long>(b) * hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_d<__nv_bfloat16>(d, q, k, v, out, b, hq, hkv, sq, skv,
                                        causal, window, scale, s)
              : launch_d<float>(d, q, k, v, out, b, hq, hkv, sq, skv, causal,
                                window, scale, s);
}
