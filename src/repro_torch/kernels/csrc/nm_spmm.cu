// Y(M, N) = X(M, K) . W with W N:M-sparse along K: in every group of M
// consecutive rows of a column, N values are kept.
//
// Replaces the TPU kernel src/repro/kernels/nm_spmm.py:nm_spmm (Pallas:
// `_kernel`, `_decompress`).  W is tiled (BK, BN); per tile it holds
// values and int8 offsets idx, both (BK / M x N, BN): packed row g x N + i
// of a column is the i-th kept value of group g, at dense row
// g x M + idx.  A dense element is the sum of its group's kept values
// whose offset names it (two equal offsets both add, an offset outside
// [0, M) adds nothing: `unpack_nm`), rounded to X's type; sums are
// float32.
//
// Three paths, picked by the host per call (kernels/tile_product.py:
// plan; the shared pieces are in tile_product.cuh):
// * Wide M, bf16 X (128-row tiles): bound by the dense tile's
//   multiply-adds, which the tensor cores run (mma.sync; M / N times the
//   kept products).  Each block decompresses each of its K tiles once,
//   straight into the bf16 weight stage of the ring: the next step's
//   values and idx are read as 16-byte / 8-byte vectors into registers
//   while mma.sync runs on the current stage; then each thread zeroes its
//   groups' M dense rows (8 columns at a time) and writes each kept value
//   at its offset, a scatter of N values into a zeroed group, not M x N
//   selects.  Where each thread's values lie is worked out once per
//   block, so a step costs no integer division.  X comes by cp.async.
// * Decode M, bf16 X (8-row tiles): bound by the kept values' bytes
//   (values + one index byte each).  No dense tile: X's columns for the
//   block's K tiles sit in shared memory (8 rows, bf16, one 16-byte
//   entry per column), and each thread walks the kept values of 4
//   columns, out[r, c] += X[r, g x M + idx] . v for every row r (the
//   paper's index matching, EIM, at the kernel's grain), so work and
//   bytes follow the kept values.  The kept values come in batches read
//   as 8-byte vectors, the next batch in flight while this one is
//   multiplied.  The K tiles of each column tile are split across
//   `splits` blocks so that N / BN column tiles still fill the card; the
//   float32 partial sums are added in split order by a second kernel, so
//   results do not depend on scheduling.
// * float32 X (or BK not 16, 32, 64, 128): the FMA path, the tile
//   decompressed into float32 shared memory by the same scatter (adding
//   where offsets tie), 8- or 64-row tiles, split as at decode M.
// Two equal offsets in a group add on every path (the tensor path sums a
// tie in float32 and rounds once); an offset outside [0, M) adds nothing
// and reads no other group's X.
// Not done yet: Hopper's 2:4 sparse tensor cores (mma.sp), which would
// multiply the kept values only (half the operations at 2:4); wgmma;
// TMA, which cannot fill a weight stage that threads build.
//
// Grid: (N / BN, splits, ceil(M / RM)).  Any M >= 1: the ragged last row
// tile is masked.  BK <= 128 and a multiple of M; BN <= 128, BN % 32 == 0;
// 1 <= N <= 4, N <= M <= 8.

#include "tile_product.cuh"

namespace {

using tile::kThreads;
using bf16 = __nv_bfloat16;
constexpr int kMaxGroup = 8;   // M
constexpr int kMaxKeep = 4;    // N

// FMA path: dense (BK, BN) tile of the weight into float32 ws.  Work item
// e is (group g, column c): zero the group's M rows, then add each kept
// value in at its offset, the sum in VT and then in XT, as `unpack_nm`
// sums in the values' type and the plain version casts to X's.
template <typename XT, typename VT>
__device__ __forceinline__ void decompress(float* ws,
                                           const VT* __restrict__ values,
                                           const int8_t* __restrict__ idx,
                                           int bk, int bn, int n_keep,
                                           int m_group, int tid) {
  const int items = bk / m_group * bn;
  for (int e = tid; e < items; e += kThreads) {
    const int g = e / bn, c = e % bn;
    float* col = ws + g * m_group * bn + c;
    for (int p = 0; p < m_group; ++p) col[p * bn] = 0.f;
    for (int i = 0; i < n_keep; ++i) {
      const int src = (g * n_keep + i) * bn + c;
      const int at = idx[src];
      if (static_cast<unsigned>(at) < static_cast<unsigned>(m_group))
        col[at * bn] = tile::round_to<XT>(tile::round_to<VT>(
            col[at * bn] + tile::to_f32<VT>(values[src])));
    }
  }
}

template <typename XT, typename VT, typename OT, int WR>
__global__ void __launch_bounds__(kThreads, 2)   // 2 blocks: 128 registers
nm_spmm_kernel(const XT* __restrict__ x, const VT* __restrict__ values,
               const int8_t* __restrict__ idx, OT* __restrict__ out,
               float* __restrict__ partial, int m, int k, int n, int bk,
               int bn, int n_keep, int m_group, int splits) {
  extern __shared__ __align__(16) float smem[];
  using S = tile::Shape<WR>;
  float* xs = smem;
  float* ws = smem + bk * S::XS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = blockIdx.x, split = blockIdx.y, m0 = blockIdx.z * S::RM;
  const int kt_count = k / bk, nt_count = n / bn;
  const int per = (kt_count + splits - 1) / splits;
  const int kt0 = min(split * per, kt_count);
  const int kt1 = min(kt0 + per, kt_count);
  const size_t tile_elems = static_cast<size_t>(bk / m_group) * n_keep * bn;

  float acc[8][tile::kMaxCJ] = {};
  for (int kt = kt0; kt < kt1; ++kt) {
    const size_t t = (static_cast<size_t>(kt) * nt_count + j) * tile_elems;
    tile::stage_x<XT, WR>(xs, x, m, k, m0, kt * bk, bk, tid);
    decompress<XT, VT>(ws, values + t, idx + t, bk, bn, n_keep, m_group, tid);
    __syncthreads();
    tile::mac<WR>(acc, xs, ws, bk, bn, warp, lane);
    __syncthreads();
  }
  tile::store<WR, OT>(acc, ws, out, splits > 1 ? partial : nullptr, split,
                      m, n, m0, j * bn, bn, warp, lane, tid);
}

// Tensor-core path: step i's K tiles kt0 + i x ks + t, t < ks
// (ks = tc::stacked(BK)), of column tile j, decompressed into a bf16
// weight stage (row stride BN + kPad) whose groups G = t x BK / M + g
// follow one another.  A unit is (group G, 8 columns c0..); thread tid
// takes units tid + 256 s, s < 8 / N, and holds all N kept slots of
// each: chunk q = s x N + i (the entry point checks that the units fit).
// Where each chunk lies is the same at every step, so it is worked out
// once (init) into desc[q]: valid (bit 31), t (bits 24-26), g (16-22),
// i (12-13), c0 (0-7).
template <typename VT>
struct NmStage {
  static constexpr int kQ = 8;
  static constexpr int kV = sizeof(VT) / 2;   // uint4 per 8 values
  const VT* values;       // column tile j of K tile kt0
  const int8_t* idx;
  size_t tile_stride;     // elements between K tiles of one column tile
  int n, bk, bn, n_keep, m_group, tid;
  uint32_t desc[kQ];
  uint4 v[kQ][kV];
  uint2 at[kQ];

  __device__ void init() {
    const int groups = bk / m_group, ks = tc::stacked(bk);
    const int units = ks * groups * (bn / 8), per = kQ / n_keep;
    const tc::Div cdiv(bn / 8), gdiv(groups);
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int s = q / n_keep, slot = q - s * n_keep;
      const int e = tid + s * kThreads;
      const int gg = cdiv.div(e), c0 = (e - gg * (bn / 8)) * 8;
      const int t = gdiv.div(gg), g = gg - t * groups;
      desc[q] = s < per && e < units
                    ? (1u << 31) | (t << 24) | (g << 16) | (slot << 12) | c0
                    : 0u;
    }
  }
  static __device__ __forceinline__ bool valid(uint32_t d) { return d >> 31; }
  static __device__ __forceinline__ int sub(uint32_t d) {
    return (d >> 24) & 7;
  }
  static __device__ __forceinline__ int group(uint32_t d) {
    return (d >> 16) & 127;
  }
  static __device__ __forceinline__ int slot(uint32_t d) {
    return (d >> 12) & 3;
  }
  static __device__ __forceinline__ int col(uint32_t d) { return d & 255; }

  __device__ int k0(int t) const { return t * bk; }

  __device__ void fetch(int i, bf16*) {
    const int ks = tc::stacked(bk);
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const uint32_t d = desc[q];
      const int t = i * ks + sub(d);
      const bool ok = valid(d) && t < n;
      const size_t off =
          static_cast<size_t>(t) * tile_stride +
          static_cast<size_t>((group(d) * n_keep + slot(d)) * bn + col(d));
      const uint4* src = reinterpret_cast<const uint4*>(values + off);
#pragma unroll
      for (int u = 0; u < kV; ++u)
        v[q][u] = ok ? __ldg(src + u) : make_uint4(0u, 0u, 0u, 0u);
      // past the last tile: offsets outside every group, so nothing lands
      at[q] = ok ? __ldg(reinterpret_cast<const uint2*>(idx + off))
                 : make_uint2(~0u, ~0u);
    }
  }

  __device__ __forceinline__ int offset(int q, int cc) const {
    const uint32_t w = cc < 4 ? at[q].x : at[q].y;
    return static_cast<int8_t>((w >> (8 * (cc % 4))) & 0xffu);
  }

  __device__ __forceinline__ float value(int q, int cc) const {
    const uint4& u = v[q][kV == 1 ? 0 : cc / 4];
    const int word = kV == 1 ? cc / 2 : cc % 4;
    const uint32_t w = word == 0   ? u.x
                       : word == 1 ? u.y
                       : word == 2 ? u.z
                                   : u.w;
    if (kV == 1) return __uint_as_float(cc % 2 ? w & 0xffff0000u : w << 16);
    return __uint_as_float(w);
  }

  // Zero each unit's M rows (8 columns), then write each kept value at
  // its offset: slot i writes the sum of its unit's slots <= i that name
  // the same row, so the last of them leaves the whole sum (ties add, in
  // float32, rounded once); no shared-memory read.
  __device__ void put(bf16* ws) {
    const int wsr = bn + tc::kPad;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const uint32_t d = desc[q];
      if (!valid(d) || slot(d) != 0) continue;
      bf16* base = ws + (sub(d) * bk + group(d) * m_group) * wsr + col(d);
      for (int p = 0; p < m_group; ++p)
        *reinterpret_cast<uint4*>(base + p * wsr) = make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const uint32_t d = desc[q];
      if (!valid(d)) continue;
      const int i = slot(d);
      bf16* base = ws + (sub(d) * bk + group(d) * m_group) * wsr + col(d);
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const int a = offset(q, cc);
        if (static_cast<unsigned>(a) >= static_cast<unsigned>(m_group))
          continue;
        float sum = value(q, cc);
#pragma unroll
        for (int back = 1; back < kMaxKeep; ++back)
          if (q - back >= 0 && back <= i && offset(q - back, cc) == a)
            sum += value(q - back, cc);
        base[a * wsr + cc] = __float2bfloat16_rn(sum);
      }
    }
  }
};

template <typename VT, typename OT>
__global__ void __launch_bounds__(kThreads, 1)
nm_spmm_mma_wide(const bf16* __restrict__ x, const VT* __restrict__ values,
                 const int8_t* __restrict__ idx, OT* __restrict__ out,
                 float* __restrict__ partial, int m, int k, int n, int bk,
                 int bn, int n_keep, int m_group, int splits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = blockIdx.x, split = blockIdx.y;
  const int m0 = blockIdx.z * tc::Layout<true>::RM;
  const int kt_count = k / bk, nt_count = n / bn;
  const int per = (kt_count + splits - 1) / splits;
  const int kt0 = min(split * per, kt_count);
  const int kt1 = min(kt0 + per, kt_count);
  const size_t tile_elems = static_cast<size_t>(bk / m_group) * n_keep * bn;
  const size_t first = (static_cast<size_t>(kt0) * nt_count + j) * tile_elems;
  NmStage<VT> w{values + first, idx + first, tile_elems * nt_count,
                kt1 - kt0, bk, bn, n_keep, m_group, tid};
  w.init();
  const int kd = tc::stage_depth(bk);
  const tc::WarpTile wt = tc::warp_tile<true>(warp, kd, bn);
  tc::Acc<true> acc = {};
  tc::mainloop<true>(acc, smem, x + kt0 * bk, m, k, m0, bk, bn, kt1 - kt0, w,
                     wt, tid, lane);
  tc::store<true, OT>(acc, smem, out, splits > 1 ? partial : nullptr, split,
                      m, n, m0, j * bn, kd, bn, wt, tid, lane);
}

// Decode path (bf16 X, 8 rows): thread tid owns 4 columns of the tile,
// 4 x (tid % (BN / 4)) .., and one of the parts = 256 / (BN / 4) shares of
// its packed rows, r = part, part + parts, ...  Its kept values are
// walked in batches of U packed rows (U x 4 values and offsets, read as
// 8- or 16-byte vectors), the next batch's loads in flight while this
// one is multiplied, the first issued before X is staged.  X's columns
// of the block's K tiles are staged once (up to kMaxCols at a time); the
// parts' sums are added in part order at the end.
template <typename VT>
struct EimBatch {
  static constexpr int kV = sizeof(VT);   // 32-bit words per 4 values
  static constexpr int U = kV == 2 ? 6 : 4;   // two batches in 128 registers
  uint32_t v[U][kV];
  uint32_t a[U];      // 4 offsets, one byte each
};

template <typename VT, typename OT>
__global__ void __launch_bounds__(kThreads, 2)
nm_spmm_eim(const bf16* __restrict__ x, const VT* __restrict__ values,
            const int8_t* __restrict__ idx, OT* __restrict__ out,
            float* __restrict__ partial, int m, int k, int n, int bk, int bn,
            int n_keep, int m_group, int splits) {
  constexpr int RM = 8, kMaxCols = 2048, U = EimBatch<VT>::U;
  constexpr int kV = EimBatch<VT>::kV;
  // xs[kk]: rows 0-7 of X at column kk of the staged K tiles, bf16; then
  // the parts' sums
  __shared__ __align__(16) uint4 xs[kMaxCols];
  float* red = reinterpret_cast<float*>(xs);
  const int tid = threadIdx.x;
  const int j = blockIdx.x, split = blockIdx.y, m0 = blockIdx.z * RM;
  const int quads = bn / 4, parts = kThreads / quads;
  const int part = tid / quads, c = (tid - part * quads) * 4;
  const bool active = part < parts;
  const int kt_count = k / bk, nt_count = n / bn;
  const int per = (kt_count + splits - 1) / splits;
  const int kt0 = min(split * per, kt_count);
  const int kt1 = min(kt0 + per, kt_count);
  const int rows_c = bk / m_group * n_keep, stage_tiles = kMaxCols / bk;
  const int rows_mine = active && part < rows_c
                            ? (rows_c - part + parts - 1) / parts
                            : 0;
  const size_t tile_elems = static_cast<size_t>(rows_c) * bn;
  const tc::Div kdiv(n_keep);

  // two cursors over the same rows: the next packed row lr of K tile lkt
  // to load, and the next one (ckt, cr) to multiply
  int lkt = kt0, lr = part, ckt = kt0, cr = part, st0 = kt0, s1 = kt0;
  auto advance = [&](int& kt, int& r) {
    r += parts;
    if (r >= rows_c) {
      r = part;
      ++kt;
    }
  };
  auto fetch = [&](EimBatch<VT>& b) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = rows_mine > 0 && lkt < s1;
      const size_t at = (static_cast<size_t>(lkt) * nt_count + j) *
                            tile_elems +
                        static_cast<size_t>(lr) * bn + c;
      if (kV == 2) {
        const uint2 w = ok ? __ldg(reinterpret_cast<const uint2*>(values + at))
                           : make_uint2(0u, 0u);
        b.v[u][0] = w.x;
        b.v[u][kV - 1] = w.y;
      } else {
        const uint4 w = ok ? __ldg(reinterpret_cast<const uint4*>(values + at))
                           : make_uint4(0u, 0u, 0u, 0u);
        b.v[u][0] = w.x;
        b.v[u][1 % kV] = w.y;
        b.v[u][2 % kV] = w.z;
        b.v[u][3 % kV] = w.w;
      }
      b.a[u] = ok ? __ldg(reinterpret_cast<const uint32_t*>(idx + at)) : ~0u;
      if (ok) advance(lkt, lr);
    }
  };
  float acc[4][RM] = {};
  auto consume = [&](const EimBatch<VT>& b) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      // X column of this row's group in the stage (offsets -1 if no row)
      const int xo = (ckt - st0) * bk + kdiv.div(cr) * m_group;
      if (rows_mine > 0 && ckt < s1) advance(ckt, cr);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int a = static_cast<int8_t>((b.a[u] >> (8 * cc)) & 0xffu);
        if (static_cast<unsigned>(a) >= static_cast<unsigned>(m_group))
          continue;   // no row here, or an offset outside the group
        float xf[8];
        tile::unpack16<bf16>(xs[xo + a], xf);
        float wv;
        if (kV == 2)
          wv = __uint_as_float(cc % 2 ? b.v[u][cc / 2] & 0xffff0000u
                                      : b.v[u][cc / 2] << 16);
        else
          wv = tile::round_to<bf16>(__uint_as_float(b.v[u][cc % kV]));
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[cc][i] = fmaf(xf[i], wv, acc[cc][i]);
      }
    }
  };

  EimBatch<VT> cur, next;
  for (; st0 < kt1; st0 += stage_tiles) {
    s1 = min(st0 + stage_tiles, kt1);
    const int cols = (s1 - st0) * bk, col0 = st0 * bk;
    const int batches = (rows_mine * (s1 - st0) + U - 1) / U;
    fetch(cur);   // in flight while X is staged
    __syncthreads();   // every thread is done with the previous X stage
    const unsigned short* xu = reinterpret_cast<const unsigned short*>(x);
    for (int kk = tid; kk < cols; kk += kThreads) {   // 8 loads in flight
      uint32_t r[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        r[i] = m0 + i < m ? xu[static_cast<size_t>(m0 + i) * k + col0 + kk]
                          : 0u;
      xs[kk] = make_uint4(r[0] | r[1] << 16, r[2] | r[3] << 16,
                          r[4] | r[5] << 16, r[6] | r[7] << 16);
    }
    __syncthreads();
    for (int bt = 0; bt < batches; ++bt) {
      if (bt + 1 < batches) fetch(next);
      consume(cur);
      cur = next;
    }
  }
  __syncthreads();
  if (active)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
#pragma unroll
      for (int i = 0; i < RM; ++i)
        red[(part * RM + i) * bn + c + cc] = acc[cc][i];
  __syncthreads();
  for (int e = tid; e < RM * bn; e += kThreads) {
    const int i = e / bn, cc = e % bn, row = m0 + i;
    if (row >= m) continue;
    float s = 0.f;
    for (int p = 0; p < parts; ++p) s += red[(p * RM + i) * bn + cc];
    const size_t at = static_cast<size_t>(row) * n + j * bn + cc;
    if (splits > 1)
      partial[static_cast<size_t>(split) * m * n + at] = s;
    else
      out[at] = tile::from_f32<OT>(s);
  }
}

template <typename XT, typename VT, typename OT, int WR>
int launch(const void* x, const void* values, const void* idx, void* out,
           void* partial, int m, int k, int n, int bk, int bn, int n_keep,
           int m_group, int splits, cudaStream_t stream) {
  auto kernel = nm_spmm_kernel<XT, VT, OT, WR>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tile::smem_bytes<WR>(tile::kMaxBK, tile::kMaxBN));
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const int rm = tile::Shape<WR>::RM;
  const dim3 grid(n / bn, splits, (m + rm - 1) / rm);
  kernel<<<grid, kThreads, tile::smem_bytes<WR>(bk, bn), stream>>>(
      static_cast<const XT*>(x), static_cast<const VT*>(values),
      static_cast<const int8_t*>(idx), static_cast<OT*>(out),
      static_cast<float*>(partial), m, k, n, bk, bn, n_keep, m_group, splits);
  return 0;
}

template <typename VT, typename OT>
int launch_wide(const void* x, const void* values, const void* idx,
                void* out, void* partial, int m, int k, int n, int bk, int bn,
                int n_keep, int m_group, int splits, cudaStream_t stream) {
  auto kernel = nm_spmm_mma_wide<VT, OT>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tc::smem_bytes<true>(tile::kMaxBK, tile::kMaxBN));
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const int rm = tc::Layout<true>::RM;
  const dim3 grid(n / bn, splits, (m + rm - 1) / rm);
  kernel<<<grid, kThreads, tc::smem_bytes<true>(bk, bn), stream>>>(
      static_cast<const bf16*>(x), static_cast<const VT*>(values),
      static_cast<const int8_t*>(idx), static_cast<OT*>(out),
      static_cast<float*>(partial), m, k, n, bk, bn, n_keep, m_group, splits);
  return 0;
}

template <typename VT, typename OT>
int launch_decode(const void* x, const void* values, const void* idx,
                  void* out, void* partial, int m, int k, int n, int bk,
                  int bn, int n_keep, int m_group, int splits,
                  cudaStream_t stream) {
  const dim3 grid(n / bn, splits, (m + 7) / 8);
  nm_spmm_eim<VT, OT><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const VT*>(values),
      static_cast<const int8_t*>(idx), static_cast<OT*>(out),
      static_cast<float*>(partial), m, k, n, bk, bn, n_keep, m_group, splits);
  return 0;
}

// One call on `path` (0 = FMA, 1 = tensor cores at wide M, 2 = the
// kept-value walk at decode M) with the row tile `rows`.
template <typename XT, typename VT, typename OT>
int launch_path(int path, int rows, const void* x, const void* values,
                const void* idx, void* out, void* partial, int m, int k,
                int n, int bk, int bn, int n_keep, int m_group, int splits,
                cudaStream_t stream) {
  int rc = static_cast<int>(cudaErrorInvalidValue);
  if constexpr (sizeof(XT) == 2) {
    if (path == 1)
      rc = launch_wide<VT, OT>(x, values, idx, out, partial, m, k, n, bk, bn,
                               n_keep, m_group, splits, stream);
    else if (path == 2)
      rc = launch_decode<VT, OT>(x, values, idx, out, partial, m, k, n, bk,
                                 bn, n_keep, m_group, splits, stream);
  }
  if (path == 0)
    rc = rows == tile::Shape<tile::kWarps>::RM
             ? launch<XT, VT, OT, tile::kWarps>(x, values, idx, out, partial,
                                                 m, k, n, bk, bn, n_keep,
                                                 m_group, splits, stream)
             : launch<XT, VT, OT, 1>(x, values, idx, out, partial, m, k, n,
                                     bk, bn, n_keep, m_group, splits, stream);
  if (rc != 0) return rc;
  if (splits > 1)
    tile::sum_splits<OT>(static_cast<const float*>(partial), out, splits,
                         static_cast<size_t>(m) * n, stream);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, typename VT>
int launch_out(int o_bf16, int path, int rows, const void* x,
               const void* values, const void* idx, void* out, void* partial,
               int m, int k, int n, int bk, int bn, int n_keep, int m_group,
               int splits, cudaStream_t stream) {
  return o_bf16 ? launch_path<XT, VT, __nv_bfloat16>(
                      path, rows, x, values, idx, out, partial, m, k, n, bk,
                      bn, n_keep, m_group, splits, stream)
                : launch_path<XT, VT, float>(path, rows, x, values, idx, out,
                                             partial, m, k, n, bk, bn, n_keep,
                                             m_group, splits, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Type flags: 0 = float32,
// 1 = bfloat16.  `path` 0 is the FMA path with the row tile `rows` 8
// (decode M) or 64; path 1 the tensor cores at wide M (rows 128), path 2
// the kept-value walk at decode M (rows 8), both for bfloat16 X only and
// BK in {16, 32, 64, 128}; path 1 also needs X and values 16-byte and
// idx 8-byte aligned.  `splits` > 1 splits the K tiles of each column
// tile over that many blocks; `partial` is then a float32 scratch buffer
// of splits x M x N.  Returns the launches' cudaGetLastError() (0 =
// success).
extern "C" int nm_spmm_launch(const void* x, const void* values,
                              const void* idx, void* out, void* partial,
                              int m, int k, int n, int bk, int bn, int n_keep,
                              int m_group, int splits, int path, int rows,
                              int x_bf16, int v_bf16, int o_bf16,
                              void* stream) {
  const bool tc_path = path == 1 || path == 2;
  const bool rows_ok =
      path == 0 ? tile::valid_rows(rows)
                : tc_path && rows == (path == 1 ? tc::Layout<true>::RM
                                                : tc::Layout<false>::RM);
  if (m < 1 || k < 1 || n < 1 || bk < 1 || bk > tile::kMaxBK || bn < 32 ||
      bn > tile::kMaxBN || bn % 32 != 0 || k % bk != 0 || n % bn != 0 ||
      m_group < 1 || m_group > kMaxGroup || n_keep < 1 || n_keep > kMaxKeep ||
      n_keep > m_group || bk % m_group != 0 || splits < 1 ||
      splits > 65535 || (splits > 1 && partial == nullptr) || !rows_ok ||
      (m + rows - 1) / rows > 65535 ||
      (tc_path && (!x_bf16 || bk % 16 != 0 || 128 % bk != 0)) ||
      (path == 1 &&
       (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(values) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(idx) % 8 != 0 ||
        tc::stage_depth(bk) / m_group * (bn / 8) >
            NmStage<float>::kQ / n_keep * kThreads)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return v_bf16 ? launch_out<__nv_bfloat16, __nv_bfloat16>(
                        o_bf16, path, rows, x, values, idx, out, partial, m,
                        k, n, bk, bn, n_keep, m_group, splits, s)
                  : launch_out<__nv_bfloat16, float>(
                        o_bf16, path, rows, x, values, idx, out, partial, m,
                        k, n, bk, bn, n_keep, m_group, splits, s);
  return v_bf16 ? launch_out<float, __nv_bfloat16>(
                      o_bf16, path, rows, x, values, idx, out, partial, m, k,
                      n, bk, bn, n_keep, m_group, splits, s)
                : launch_out<float, float>(o_bf16, path, rows, x, values, idx,
                                           out, partial, m, k, n, bk, bn,
                                           n_keep, m_group, splits, s);
}
