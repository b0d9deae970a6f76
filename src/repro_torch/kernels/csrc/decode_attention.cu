// Single-token (decode) attention against the contiguous slotted KV cache:
// out[b, h] = softmax(q[b, h] . K[b, :, h / g]^T / sqrt(D), masked) V[b, :, h / g]
// for q (B, 1, Hq, D) and caches (B, C, Hkv, D), g = Hq / Hkv.
//
// Replaces no TPU kernel.  The reference's decode attention
// (src/repro/models/layers.py: decode_attention) is two jnp einsums around
// a masked softmax that XLA fuses, reading the cache in its own type with
// float32 accumulation.  Written out in eager PyTorch the same function
// made float32 copies of every line of both caches and ran f32 products
// over all C lines of every slot, per layer and step; this kernel computes
// it reading the cache in place, and only the lines each slot can see.
//
// Semantics (kernels/decode_attention.py: decode_attention_ref): q is
// rounded to the cache type; scores are float32 sums of the products times
// D^-0.5; a line holding position p is valid when 0 <= p <= pos and, with a
// window, pos - p < window.  Without `ring` line i holds position i (pos
// past C - 1 sees all C lines); with `ring` position p lies at line p % C
// and the valid lines are the min(window, pos + 1, C) latest positions.
// The softmax is float32, p is rounded to the cache type before the PV
// product, which sums in float32, and the output is cast to q's type.  A
// slot with no valid line at all (pos < 0, or a window that ends before
// line 0 without ring) attends uniformly to all C lines, as the plain
// version's softmax over C scores of -1e30 does.
//
// What bounds it on the H100: the bytes of the valid K and V lines (4 D
// operations per 4 D bytes of bf16: far below the card's ~295 operations a
// byte).  So:
// - Only valid lines are read, each once per call (for g <= 16: one block
//   serves up to 16 query heads of one KV head, so grouped-query heads
//   share every load); `pos` is read on the device, no host sync.
// - The valid positions of a slot are cut into splits of kSplit positions
//   aligned to multiples of kSplit (absolute positions, so that a call's
//   result for a slot depends on neither the batch, nor C, nor the layout:
//   paged and contiguous caches give the same bits).  Grid (splits sized
//   from C, Hkv x head groups, B); a block whose split holds no valid
//   position exits at once.
// - A block streams its split's K tiles, then its V tiles, through a
//   kStages-deep ring of kTileBytes stages in shared memory, filled by
//   16-byte cp.async (the next three tiles in flight while one is used).
//   Scores: threads-per-line lanes each dot a quarter (or so) of a line
//   with q (in shared memory, float32), a xor-shuffle sum; the split's
//   scores stay in shared memory.  The split's softmax is taken whole
//   (max, exp, sum, divide), p rounded to the cache type; PV: a thread per
//   output element (head, d) walks the tile's lines.
// - One split (C <= kSplit without ring): the block writes the output.
//   Else each split writes (m, l, its normalised float32 output) and a
//   second launch combines a slot's splits in order, weights l_k e^{m_k - M}
//   over their sum: a slot whose valid lines lie in one split gets that
//   split's output bit for bit, the plain version's arithmetic.
// Deterministic: every sum runs in a fixed order, no atomics; two launches
// at most, no allocation, capturable in a CUDA graph.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSplit = 256;       // positions per split
constexpr int kSS = kSplit + 1;   // score row stride (floats)
constexpr int kTileBytes = 8192;  // one ring stage, before padding
constexpr int kStages = 4;
constexpr int kHeads = 16;        // query heads one block serves at most
constexpr float kMasked = -1e30f;

template <typename T, int D>
struct Cfg {
  static constexpr int CH = 16 / static_cast<int>(sizeof(T));  // elements per 16-byte chunk
  static constexpr int CPL = D / CH;                            // chunks per line
  static constexpr int TL0 = kTileBytes / (D * static_cast<int>(sizeof(T)));
  static constexpr int TL = TL0 < kSplit ? TL0 : kSplit;        // lines per tile
  static constexpr int TPL = TL >= kThreads ? 1 : kThreads / TL;  // score lanes per line
  static constexpr int LPT = TL >= kThreads ? TL / kThreads : 1;  // score lines per thread
  static constexpr int CPT = CPL / TPL;                         // score chunks per lane
  // 16 bytes of padding per score lane (at most 8): a quarter warp's
  // 16-byte reads of K fall in distinct banks
  static constexpr int PAD = TPL < 8 ? TPL : 8;
  static constexpr int RS = (CPL + PAD) * CH;                   // tile row stride (elements)
  static constexpr int STAGE = TL * RS;                         // elements per stage
  static constexpr int RING = kStages * STAGE * static_cast<int>(sizeof(T));
  static constexpr int MAXOUT = kHeads * D / kThreads;          // PV outputs per thread
  static_assert(CPL % TPL == 0 && TL * TPL >= kThreads, "tile shape");
};

__host__ __device__ constexpr int smem_bytes(int ring, int d, int heads) {
  return ring + 4 * (heads * (d + kSS) + kThreads);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A 16-byte chunk of T as floats.
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
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ long long read_pos(const void* pos, int stride,
                                              int pos64, int b) {
  return pos64 ? static_cast<const long long*>(pos)[
                     static_cast<long long>(b) * stride]
               : static_cast<long long>(static_cast<const int*>(pos)[
                     static_cast<long long>(b) * stride]);
}

// The valid positions [lo, hi] of a slot at `pos`; with none valid, all
// C lines as positions 0..C-1, `uniform`.
struct Range {
  long long lo, hi;
  bool uniform;
};

__device__ __forceinline__ Range valid_range(long long pos, int c, int window,
                                             int ring) {
  long long lo, hi;
  if (ring) {
    long long n = pos + 1;
    if (window > 0 && window < n) n = window;
    if (c < n) n = c;
    lo = pos - n + 1;
    hi = pos;
  } else {
    hi = pos < c - 1 ? pos : c - 1;
    lo = window > 0 && pos - window + 1 > 0 ? pos - window + 1 : 0;
  }
  if (pos < 0 || lo > hi) return {0, c - 1LL, true};
  return {lo, hi, false};
}

// Copy `count` lines of one KV head, positions p0.., into a ring stage
// (row stride RS), 16-byte cp.async each, left in flight.
template <typename T, int D>
__device__ __forceinline__ void issue_tile(T* dst, const T* __restrict__ head,
                                           long long p0, int count, int c,
                                           bool wrap, long long line_stride) {
  using C = Cfg<T, D>;
  const long long line0 = wrap ? p0 % c : p0;
  for (int i = threadIdx.x; i < count * C::CPL; i += kThreads) {
    const int j = i / C::CPL, cc = i % C::CPL;
    long long line = line0 + j;
    if (wrap && line >= c) line -= c;
    cp_async16(dst + j * C::RS + cc * C::CH,
               head + line * line_stride + cc * C::CH);
  }
}

// Scores of the tile's lines j0.. (count of them) for the block's gb heads
// into ss[h * kSS + j0 + j].
template <typename T, int D>
__device__ __forceinline__ void score_tile(const T* ks, const float* qs,
                                           float* ss, int j0, int count,
                                           int gb, float scale,
                                           bool uniform) {
  using C = Cfg<T, D>;
  const int part = threadIdx.x % C::TPL;
#pragma unroll
  for (int li = 0; li < C::LPT; ++li) {
    const int j = threadIdx.x / C::TPL + li * (kThreads / C::TPL);
    const T* row = ks + j * C::RS;
    for (int h0 = 0; h0 < gb; h0 += 4) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int u = 0; u < C::CPT; ++u) {
        const int c = part + u * C::TPL;
        float kf[C::CH];
        unpack16<T>(*reinterpret_cast<const uint4*>(row + c * C::CH), kf);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (h0 + e < gb) {
            const float4* q4 =
                reinterpret_cast<const float4*>(qs + (h0 + e) * D + c * C::CH);
#pragma unroll
            for (int x = 0; x < C::CH / 4; ++x) {
              const float4 qv = q4[x];
              s[e] = fmaf(qv.x, kf[4 * x], s[e]);
              s[e] = fmaf(qv.y, kf[4 * x + 1], s[e]);
              s[e] = fmaf(qv.z, kf[4 * x + 2], s[e]);
              s[e] = fmaf(qv.w, kf[4 * x + 3], s[e]);
            }
          }
        }
      }
#pragma unroll
      for (int off = C::TPL / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[e] += __shfl_xor_sync(0xffffffffu, s[e], off);
      }
      if (part == 0 && j < count) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (h0 + e < gb)
            ss[(h0 + e) * kSS + j0 + j] = uniform ? kMasked : s[e] * scale;
      }
    }
  }
}


// The split's softmax over its nl scores, a warp per head: p normalised
// over the split and rounded to T, in place; (m, l) of head h to
// ml[h * ml_stride] when the call combines splits.
template <typename T>
__device__ __forceinline__ void split_softmax(float* ss, int nl, int gb,
                                              float* ml, long long ml_stride) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int h = warp; h < gb; h += kThreads / 32) {
    float* s = ss + h * kSS;
    float m = kMasked;
    for (int j = lane; j < nl; j += 32) m = fmaxf(m, s[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int j = lane; j < nl; j += 32) {
      const float p = expf(s[j] - m);
      s[j] = p;
      l += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    for (int j = lane; j < nl; j += 32) s[j] = round_to<T>(s[j] / l);
    if (ml != nullptr && lane == 0) {
      ml[h * ml_stride] = m;
      ml[h * ml_stride + 1] = l;
    }
  }
}

// acc[i] += p V over the tile's lines for output o = tid % W + i W of the
// block's gb x D (W = min(units, kThreads)); with units < kThreads the
// reps = kThreads / units replicas take lines r, r + reps, ...
template <typename T, int D>
__device__ __forceinline__ void pv_tile(const T* vs, const float* ps, int j0,
                                        int count, int units, int reps,
                                        float (&acc)[Cfg<T, D>::MAXOUT]) {
  using C = Cfg<T, D>;
  const int w = units < kThreads ? units : kThreads;
  const int r = threadIdx.x / w;
  if (r >= reps) return;
#pragma unroll
  for (int i = 0; i < C::MAXOUT; ++i) {
    const int o = threadIdx.x % w + i * w;
    if (o < units) {
      const float* p = ps + (o / D) * kSS + j0;
      const T* v = vs + o % D;
      for (int j = r; j < count; j += reps)
        acc[i] = fmaf(p[j], to_f32<T>(v[j * C::RS]), acc[i]);
    }
  }
}

__device__ __forceinline__ void store_out(void* out, long long at, int bf16,
                                          float x) {
  if (bf16)
    static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(out)[at] = x;
}

// Block (split, KV head x head group, slot).  With part_acc null the call
// has one split and the block writes out; else its float32 output to
// part_acc[((b Hq + h) S + split) D + d] and (m, l) to part_ml[(... ) 2].
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_split(const void* __restrict__ q, long long q_sb, int q_bf16,
                       const T* __restrict__ kc, const T* __restrict__ vc,
                       const void* __restrict__ pos, int pos_stride,
                       int pos64, void* __restrict__ out,
                       float* __restrict__ part_acc,
                       float* __restrict__ part_ml, int c, int hq, int hkv,
                       int window, int ring, float scale) {
  using C = Cfg<T, D>;
  const int b = blockIdx.z;
  const int g = hq / hkv;
  const int groups = (g + kHeads - 1) / kHeads;
  const int kvh = blockIdx.y / groups;
  const int qh0 = kvh * g + (blockIdx.y % groups) * kHeads;  // first query head
  const int gb = min(kHeads, kvh * g + g - qh0);
  const Range rg = valid_range(read_pos(pos, pos_stride, pos64, b), c,
                               window, ring);
  const long long first = (rg.lo / kSplit + blockIdx.x) * kSplit;
  const long long p0 = rg.lo > first ? rg.lo : first;
  const long long p1 =
      rg.hi < first + kSplit - 1 ? rg.hi : first + kSplit - 1;
  if (p0 > p1) return;  // the slot's valid positions end before this split
  const int nl = static_cast<int>(p1 - p0 + 1);
  const bool wrap = ring && !rg.uniform;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ring_s = reinterpret_cast<T*>(smem);
  float* qs = reinterpret_cast<float*>(smem + C::RING);
  float* ss = qs + min(kHeads, g) * D;
  float* red = ss + min(kHeads, g) * kSS;

  const long long line_stride = static_cast<long long>(hkv) * D;
  const long long head_off =
      static_cast<long long>(b) * c * line_stride + static_cast<long long>(kvh) * D;
  const T* kh = kc + head_off;
  const T* vh = vc + head_off;
  const int nt = (nl + C::TL - 1) / C::TL;  // tiles of K, then as many of V
  auto issue = [&](int t) {
    const int tt = t < nt ? t : t - nt;
    issue_tile<T, D>(ring_s + (t % kStages) * C::STAGE, t < nt ? kh : vh,
                     p0 + static_cast<long long>(tt) * C::TL,
                     min(C::TL, nl - tt * C::TL), c, wrap, line_stride);
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < 2 * nt) issue(t);
    cp_async_commit();
  }

  // q rounded to T, as float
  for (int i = threadIdx.x; i < gb * D; i += kThreads) {
    const long long at = b * q_sb + static_cast<long long>(qh0) * D + i;
    const float x =
        q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[at])
               : static_cast<const float*>(q)[at];
    qs[i] = round_to<T>(x);
  }

  const int units = gb * D;
  const int reps = units < kThreads ? kThreads / units : 1;
  float acc[C::MAXOUT];
#pragma unroll
  for (int i = 0; i < C::MAXOUT; ++i) acc[i] = 0.f;
  const long long row0 = static_cast<long long>(b) * hq + qh0;
  const long long splits = gridDim.x;
  for (int t = 0; t < 2 * nt; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has landed (this thread's copies)
    __syncthreads();               // everyone's, and tile t - 1 is used up
    if (t + kStages - 1 < 2 * nt) issue(t + kStages - 1);
    cp_async_commit();
    const T* tile = ring_s + (t % kStages) * C::STAGE;
    if (t < nt) {
      score_tile<T, D>(tile, qs, ss, t * C::TL, min(C::TL, nl - t * C::TL),
                       gb, scale, rg.uniform);
      continue;
    }
    if (t == nt) {
      split_softmax<T>(ss, nl, gb,
                       part_ml == nullptr
                           ? nullptr
                           : part_ml + (row0 * splits + blockIdx.x) * 2,
                       splits * 2);
      __syncthreads();
    }
    const int tt = t - nt;
    pv_tile<T, D>(tile, ss, tt * C::TL, min(C::TL, nl - tt * C::TL), units,
                  reps, acc);
  }
  cp_async_wait<0>();

  if (reps > 1) {  // the replicas' sums, in order
    if (threadIdx.x < reps * units) red[threadIdx.x] = acc[0];
    __syncthreads();
    if (threadIdx.x < units) {
      float s = 0.f;
      for (int r = 0; r < reps; ++r) s += red[r * units + threadIdx.x];
      acc[0] = s;
    }
  }
  const int w = units < kThreads ? units : kThreads;
  if (threadIdx.x >= w) return;
#pragma unroll
  for (int i = 0; i < C::MAXOUT; ++i) {
    const int o = threadIdx.x + i * w;
    if (o < units) {
      const long long row = row0 + o / D;
      if (part_acc == nullptr)
        store_out(out, row * D + o % D, q_bf16, acc[i]);
      else
        part_acc[(row * splits + blockIdx.x) * D + o % D] = acc[i];
    }
  }
}

// Block (query head, slot), a thread per d: the slot's splits in order,
// weights l_k e^{m_k - M} over their sum (exactly 1 for a lone split).
__global__ void decode_attention_combine(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const void* __restrict__ pos, int pos_stride, int pos64,
    void* __restrict__ out, int out_bf16, int c, int hq, int d, int window,
    int ring, int splits) {
  const int b = blockIdx.y;
  const Range rg = valid_range(read_pos(pos, pos_stride, pos64, b), c,
                               window, ring);
  const int ns = static_cast<int>(rg.hi / kSplit - rg.lo / kSplit + 1);
  const long long row = static_cast<long long>(b) * hq + blockIdx.x;
  const float* ml = part_ml + row * splits * 2;
  const float* acc = part_acc + row * splits * d;
  float mx = kMasked;
  for (int k = 0; k < ns; ++k) mx = fmaxf(mx, ml[2 * k]);
  float den = 0.f;
  for (int k = 0; k < ns; ++k) den += ml[2 * k + 1] * expf(ml[2 * k] - mx);
  for (int x = threadIdx.x; x < d; x += blockDim.x) {
    float o = 0.f;
    for (int k = 0; k < ns; ++k)
      o = fmaf(ml[2 * k + 1] * expf(ml[2 * k] - mx) / den, acc[k * d + x], o);
    store_out(out, row * d + x, out_bf16, o);
  }
}

// Splits a slot can need along a cache of c lines: the widest valid range
// the lines hold, cut at multiples of kSplit (a ring's window may straddle
// one boundary more than its length fills).
int num_splits(int c, int window, int ring) {
  int n = (c + kSplit - 1) / kSplit;
  if (ring) {
    const int w = window > 0 && window < c ? window : c;
    const int r = (w + kSplit - 1) / kSplit + 1;
    n = r > n ? r : n;
  }
  return n;
}

// float32 scratch of a call: (D + 2) per (slot, query head, split) with
// more than one split, else none.
long long scratch_floats(int b, int c, int hq, int d, int window, int ring) {
  const int n = num_splits(c, window, ring);
  return n > 1 ? static_cast<long long>(b) * hq * n * (d + 2) : 0;
}

template <typename T, int D>
int launch(const void* q, long long q_sb, int q_bf16, const void* k,
           const void* v, const void* pos, int pos_stride, int pos64,
           void* out, float* part, int b, int c, int hq, int hkv, int window,
           int ring, float scale, int splits, cudaStream_t stream) {
  using C = Cfg<T, D>;
  auto kernel = decode_attention_split<T, D>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(C::RING, D, kHeads));
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const int g = hq / hkv;
  const dim3 grid(splits, hkv * ((g + kHeads - 1) / kHeads), b);
  float* part_ml =
      part == nullptr ? nullptr
                      : part + static_cast<long long>(b) * hq * splits * D;
  kernel<<<grid, kThreads, smem_bytes(C::RING, D, g < kHeads ? g : kHeads),
           stream>>>(q, q_sb, q_bf16, static_cast<const T*>(k),
                     static_cast<const T*>(v), pos, pos_stride, pos64, out,
                     part, part_ml, c, hq, hkv, window, ring, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return static_cast<int>(err);
  decode_attention_combine<<<dim3(hq, b), D, 0, stream>>>(
      part, part_ml, pos, pos_stride, pos64, out, q_bf16, c, hq, D, window,
      ring, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int d, const void* q, long long q_sb, int q_bf16, const void* k,
             const void* v, const void* pos, int pos_stride, int pos64,
             void* out, float* part, int b, int c, int hq, int hkv,
             int window, int ring, float scale, int splits,
             cudaStream_t s) {
  switch (d) {
#define DECODE_ATTENTION_D(DIM)                                               \
  case DIM:                                                                   \
    return launch<T, DIM>(q, q_sb, q_bf16, k, v, pos, pos_stride, pos64, out, \
                          part, b, c, hq, hkv, window, ring, scale, splits, s);
    DECODE_ATTENTION_D(16)
    DECODE_ATTENTION_D(32)
    DECODE_ATTENTION_D(64)
    DECODE_ATTENTION_D(128)
    DECODE_ATTENTION_D(256)
#undef DECODE_ATTENTION_D
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  q (B, 1, Hq, D) float32
// (q_bf16 = 0) or bfloat16, batch stride q_sb elements, each head's D
// contiguous; k, v (B, C, Hkv, D) contiguous, 16-byte aligned, float32
// (bf16 = 0) or bfloat16; pos int32 (pos64 = 0) or int64, slot b's at
// pos[b * pos_stride] (stride 0: one shared position); out (B, 1, Hq, D)
// contiguous in q's type; D in {16, 32, 64, 128, 256}; window <= 0 means
// none.  part holds part_floats float32 of scratch, at least
// decode_attention_scratch(b, c, hq, d, window, ring) (two launches); where
// that is 0 part is not read (one launch).  Returns the launches'
// cudaGetLastError() (0 = success).
extern "C" int decode_attention_launch(
    const void* q, long long q_sb, int q_bf16, const void* k, const void* v,
    const void* pos, int pos_stride, int pos64, void* out, void* part,
    long long part_floats, int b, int c, int hq, int hkv, int d, int window,
    int ring, float scale, int bf16, void* stream) {
  if (b < 1 || b > 65535 || c < 1 || hkv < 1 || hq < hkv || hq % hkv != 0 ||
      static_cast<long long>(hkv) * ((hq / hkv + kHeads - 1) / kHeads) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long need = scratch_floats(b, c, hq, d, window, ring);
  if (need > 0 && (part == nullptr || part_floats < need))
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = num_splits(c, window, ring);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = need > 0 ? static_cast<float*>(part) : nullptr;
  return bf16 ? launch_d<__nv_bfloat16>(d, q, q_sb, q_bf16, k, v, pos,
                                        pos_stride, pos64, out, p, b, c, hq,
                                        hkv, window, ring, scale, splits, s)
              : launch_d<float>(d, q, q_sb, q_bf16, k, v, pos, pos_stride,
                                pos64, out, p, b, c, hq, hkv, window, ring,
                                scale, splits, s);
}

// float32 scratch decode_attention_launch needs for these sizes (0: one
// split, no scratch), so that the split count is decided here alone.
extern "C" long long decode_attention_scratch(int b, int c, int hq, int d,
                                              int window, int ring) {
  return scratch_floats(b, c, hq, d, window, ring);
}
