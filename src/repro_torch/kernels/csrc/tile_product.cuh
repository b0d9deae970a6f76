// Shared pieces of the dense-X x sparse-W tile products (block_sparse.cu,
// nm_spmm.cu).  Three paths; the host picks one per call
// (kernels/tile_product.py: plan), and each computes what the plain
// version computes: the weight rounded to X's type, float32 sums, the
// output cast to its type.
//
// 1. FMA path (namespace tile; float32 X, or a BK the tensor path does not
//    take): one block of 256 threads owns an output tile of RM rows x
//    BN columns (BN <= 128, BN % 32 == 0) and walks the K tiles the
//    weight keeps, each staged in shared memory as float32:
//      xs[kk * XS + r]   the X tile, transposed (BK x RM, row stride XS)
//      ws[kk * BN + c]   the weight tile (BK x BN), rounded to X's type
//    Warps are laid out WR along rows (8 rows each) by WK = 8 / WR along
//    the K tile: at decode M (WR = 1) all eight warps share the same 8
//    rows and take every eighth row of the K tile, and their sums are
//    added in a fixed order at the end.  Lane l owns columns l + 32 j.
//    Bound by the FMA units at wide M (16-25 TFLOP/s on the H100); kept
//    for float32 X, which both plain versions compute in full float32
//    (TF32 would change the numbers).
// 2. Tensor-core path (namespace tc; bf16 X, BK 16, 32, 64 or 128): X and
//    the weight sit in shared memory as bf16, rows padded by 16 bytes so
//    that ldmatrix is free of bank conflicts, 128 / BK K tiles stacked in
//    each 128-deep stage of a ring (three stages at wide M, one block per
//    SM; two at decode M, so that three blocks fit): X by cp.async
//    (16-byte copies, ragged rows zero-filled), the weight by cp.async or
//    by its producer's threads from registers loaded one stage ahead, so
//    that the next steps' loads are in flight during this step's
//    mma.sync.m16n8k16 (bf16 in, float32 sums).  One barrier per step;
//    index arithmetic by multiply-shift (Div), not integer division.
//    Wide M (RM = 128): 8 warps as 2 x 4, each on 64 x BN/4 of the
//    output, bound by the tensor cores' rate.  Decode M (RM = 8): the A
//    fragments' rows 8-15 are zero registers; warps split the stage's
//    16-deep steps (and the columns when the stage is shallower), and
//    their sums are added in a fixed order; bound by the weight bytes.
// 3. K4's kept-value walk at decode M (nm_spmm.cu), which uses only the
//    conversions and Div here.
// Not done yet: wgmma and TMA (the next design step for K3), 2:4 sparse
// tensor cores (mma.sp) for K4, warp-specialised producers.
// Everything here has internal linkage: each source that includes it
// keeps its own copy of the kernels.
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

namespace tc {

using bf16 = __nv_bfloat16;
using tile::kThreads;
constexpr int kPad = 8;   // bf16 elements added to each shared-memory row

// Output rows per block, m16 tiles and at most n8 tiles per warp, ring
// stages (wide M: three, one block per SM; decode M: two, so that three
// blocks fit on an SM).
template <bool WIDE>
struct Layout {
  static constexpr int RM = WIDE ? 128 : 8;
  static constexpr int MI = WIDE ? 4 : 1;
  static constexpr int NJ = WIDE ? 4 : 16;
  static constexpr int STAGES = WIDE ? 3 : 2;
};

// K tiles stacked in one ring stage: a stage is KD = 128 / BK x BK = 128
// deep (BK divides 128), so that tiles shallower than 128 still give each
// step 128-deep work.
__host__ __device__ inline int stacked(int bk) { return 128 / bk; }
__host__ __device__ inline int stage_depth(int bk) { return stacked(bk) * bk; }

// At decode M the warps share the block's output: kw = warp % wk takes
// every wk-th 16-deep step of the stage (KD deep), nw = warp / wk a
// 1 / wn share of the columns (wn a power of two dividing BN / 8).
__host__ __device__ inline int decode_wk(int kd) {
  return kd / 16 < 8 ? kd / 16 : 8;
}
__host__ __device__ inline int decode_wn(int kd, int bn) {
  int wn = 8 / decode_wk(kd);
  while ((bn / 8) % wn != 0) wn /= 2;
  return wn;
}

// One stage of the ring: X (RM x KD) then the weight (KD x BN), bf16.
template <bool WIDE>
__host__ __device__ inline int stage_elems(int bk, int bn) {
  const int kd = stage_depth(bk);
  return Layout<WIDE>::RM * (kd + kPad) + kd * (bn + kPad);
}

// Dynamic shared memory: the ring; at decode M the warps' float32 sums
// reuse it at the end (wk x 8 rows x BN).
template <bool WIDE>
__host__ __device__ inline int smem_bytes(int bk, int bn) {
  const int ring = Layout<WIDE>::STAGES * stage_elems<WIDE>(bk, bn) * 2;
  const int red = WIDE ? 0 : decode_wk(stage_depth(bk)) * 8 * bn * 4;
  return ring > red ? ring : red;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zeros when !valid (src must
// still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most `pending` of this thread's newest groups are in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1,
                                          const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, float32 sums.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// n / d and n % d by a multiply and a shift, exact for 0 <= n, n x d <=
// 65536: the tile products divide small indices by runtime tile sizes.
struct Div {
  int d, m;
  __device__ explicit Div(int d_) : d(d_), m((65536 + d_ - 1) / d_) {}
  __device__ __forceinline__ int div(int n) const { return (n * m) >> 16; }
  __device__ __forceinline__ int mod(int n) const { return n - div(n) * d; }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The part of the block's output one warp computes.
struct WarpTile {
  int row0, col0;   // first row and column within the block's tile
  int nj;           // n8 tiles
  int ks0, kstep;   // 16-deep steps ks0, ks0 + kstep, ... of each stage
  int kw;           // decode: which of the wk warps sharing these columns
  bool active;
};

template <bool WIDE>
__device__ __forceinline__ WarpTile warp_tile(int warp, int kd, int bn) {
  if (WIDE)   // 2 x 4 warps, 64 x BN / 4 each, every step
    return {(warp % 2) * 64, (warp / 2) * (bn / 4), bn / 32, 0, 1, 0, true};
  const int wk = decode_wk(kd), wn = decode_wn(kd, bn), nj = bn / 8 / wn;
  return {0, (warp / wk) * nj * 8, nj, warp % wk, wk, warp % wk,
          warp < wk * wn};
}

template <bool WIDE>
using Acc = float[Layout<WIDE>::MI][Layout<WIDE>::NJ][4];

// acc += the warp's share of X stage xs (RM x KD) . W stage ws (KD x BN).
template <bool WIDE>
__device__ __forceinline__ void mma_tile(Acc<WIDE>& acc, const bf16* xs,
                                         const bf16* ws, int kd, int bn,
                                         const WarpTile& wt, int lane) {
  constexpr int MI = Layout<WIDE>::MI, NJ = Layout<WIDE>::NJ;
  const int xsr = kd + kPad, wsr = bn + kPad;
  if (!wt.active) return;
  for (int ks = wt.ks0; ks < kd / 16; ks += wt.kstep) {
    const int kk = ks * 16;
    uint32_t a[MI][4];
    if (WIDE) {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldsm_x4(a[mi], xs + (wt.row0 + mi * 16 + lane % 16) * xsr + kk +
                           (lane / 16) * 8);
    } else {   // rows 8-15 of the fragment are zero
      ldsm_x2(a[0][0], a[0][2],
              xs + (lane % 8) * xsr + kk + ((lane / 8) % 2) * 8);
      a[0][1] = 0u;
      a[0][3] = 0u;
    }
    const bf16* wrow = ws + (kk + lane % 16) * wsr + wt.col0;
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      if (j >= wt.nj) continue;   // not a break: acc stays in registers
      uint32_t b[4];
      if (j + 1 < wt.nj) {
        ldsm_x4_t(b, wrow + j * 8 + (lane / 16) * 8);
      } else {
        ldsm_x2_t(b[0], b[1], wrow + j * 8);
        b[2] = b[3] = 0u;
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        mma(acc[mi][j], a[mi], b[0], b[1]);
        if (j + 1 < wt.nj) mma(acc[mi][j + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

// The block's K loop over `tiles` K tiles (stacked() of them per step)
// through a ring of Layout::STAGES stages, loads issued STAGES - 1 steps
// ahead (the register producers' one step ahead: they hold one step).
// One barrier per step.  X comes by cp.async: K tile t at columns
// w.k0(t), zero past row m and past the last tile; the producer `w` fills
// the weight stage: fetch(i, ws) starts step i's loads (cp.async into ws,
// or global loads into its registers) and put(ws) writes what fetch
// loaded into ws (nothing for cp.async producers).  A stage's rows past
// the last tile are zero in both, so they add nothing.
template <bool WIDE, typename W>
__device__ __forceinline__ void mainloop(Acc<WIDE>& acc, bf16* smem,
                                         const bf16* __restrict__ x, int m,
                                         int k, int m0, int bk, int bn,
                                         int tiles, W& w, const WarpTile& wt,
                                         int tid, int lane) {
  constexpr int RM = Layout<WIDE>::RM;
  const int ks = stacked(bk), kd = ks * bk, xsr = kd + kPad;
  const int chunks = kd / 8, tile_chunks = bk / 8;
  const int steps = (tiles + ks - 1) / ks;
  const int stage = stage_elems<WIDE>(bk, bn);
  auto xs = [&](int s) { return smem + s * stage; };
  auto ws = [&](int s) { return smem + s * stage + RM * xsr; };
  const Div cdiv(chunks), tdiv(tile_chunks);
  auto load_x = [&](int i, int s) {
    bf16* dst = xs(s);
    int last = -1, k0 = 0;   // a thread's chunks mostly share one tile
    for (int e = tid; e < RM * chunks; e += kThreads) {
      const int r = cdiv.div(e), c = e - r * chunks, row = m0 + r;
      const int sub = tdiv.div(c), t = i * ks + sub;
      const bool valid = row < m && t < tiles;
      if (valid && t != last) {
        k0 = w.k0(t);
        last = t;
      }
      cp_async16(dst + r * xsr + c * 8,
                 valid ? x + static_cast<size_t>(row) * k + k0 +
                             (c - sub * tile_chunks) * 8
                       : x,
                 valid);
    }
  };
  constexpr int S = Layout<WIDE>::STAGES;
  if (steps <= 0) return;
#pragma unroll
  for (int p = 0; p < S - 1; ++p) {
    if (p < steps) {
      load_x(p, p);
      w.fetch(p, ws(p));
    }
    cp_async_commit();
    if (p < steps) w.put(ws(p));
  }
  for (int i = 0; i < steps; ++i) {
    const int s = i % S, ahead = i + S - 1, sa = ahead % S;
    cp_async_wait<S - 2>();   // step i has landed
    __syncthreads();   // stage s visible; every warp is past step i - 1
    if (ahead < steps) {
      load_x(ahead, sa);
      w.fetch(ahead, ws(sa));
    }
    cp_async_commit();   // one group per step, empty or not
    mma_tile<WIDE>(acc, xs(s), ws(s), kd, bn, wt, lane);
    if (ahead < steps) w.put(ws(sa));
  }
}

// Two float32 values into out (M, N) at (row, col), col even, or into
// split `split` of the partial sums (splits, M, N).
template <typename OT>
__device__ __forceinline__ void put2(OT* __restrict__ out,
                                     float* __restrict__ partial, int split,
                                     int m, int n, int row, int col, float v0,
                                     float v1) {
  if (row >= m) return;
  const size_t at = static_cast<size_t>(row) * n + col;
  if (partial != nullptr) {
    *reinterpret_cast<float2*>(partial + static_cast<size_t>(split) * m * n +
                               at) = make_float2(v0, v1);
  } else if constexpr (sizeof(OT) == 2) {
    *reinterpret_cast<__nv_bfloat162*>(out + at) =
        __floats2bfloat162_rn(v0, v1);
  } else {
    *reinterpret_cast<float2*>(out + at) = make_float2(v0, v1);
  }
}

// The block's sums into out at columns n0.. (or its split of `partial`).
// Decode M: the wk warps sharing columns are added in warp order through
// shared memory (the ring, free once every warp is past its last step).
template <bool WIDE, typename OT>
__device__ __forceinline__ void store(const Acc<WIDE>& acc, bf16* smem,
                                      OT* __restrict__ out,
                                      float* __restrict__ partial, int split,
                                      int m, int n, int m0, int n0, int kd,
                                      int bn, const WarpTile& wt, int tid,
                                      int lane) {
  constexpr int MI = Layout<WIDE>::MI, NJ = Layout<WIDE>::NJ;
  const int g = lane / 4, c2 = (lane % 4) * 2;
  if (WIDE) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j >= wt.nj) continue;
        const int row = m0 + wt.row0 + mi * 16 + g;
        const int col = n0 + wt.col0 + j * 8 + c2;
        put2<OT>(out, partial, split, m, n, row, col, acc[mi][j][0],
                 acc[mi][j][1]);
        put2<OT>(out, partial, split, m, n, row + 8, col, acc[mi][j][2],
                 acc[mi][j][3]);
      }
    return;
  }
  float* red = reinterpret_cast<float*>(smem);
  __syncthreads();
  if (wt.active) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j >= wt.nj) continue;
      float* at = red + (wt.kw * 8 + g) * bn + wt.col0 + j * 8 + c2;
      at[0] = acc[0][j][0];
      at[1] = acc[0][j][1];
    }
  }
  __syncthreads();
  const int wk = decode_wk(kd);
  for (int e = tid; e < 8 * bn / 2; e += kThreads) {
    const int r = e / (bn / 2), c = (e % (bn / 2)) * 2;
    float s0 = 0.f, s1 = 0.f;
    for (int w = 0; w < wk; ++w) {
      s0 += red[(w * 8 + r) * bn + c];
      s1 += red[(w * 8 + r) * bn + c + 1];
    }
    put2<OT>(out, partial, split, m, n, m0 + r, n0 + c, s0, s1);
  }
}

}  // namespace tc
}  // namespace
