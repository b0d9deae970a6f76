// Y(M, N) = X(M, K) . W with W N:M-sparse along K: in every group of M
// consecutive rows of a column, N values are kept.
//
// Replaces the TPU kernel src/repro/kernels/nm_spmm.py:nm_spmm (Pallas:
// `_kernel`, `_decompress`).  W is tiled (BK, BN); per tile it holds
// values and int8 offsets idx, both (BK / M x N, BN): packed row g x N + i
// of a column is the i-th kept value of group g, at dense row
// g x M + idx.  Each K tile is decompressed into a dense (BK, BN) tile in
// shared memory, every dense element the sum of the group's kept values
// whose offset names it (the reference's M x N selects), rounded to X's
// type; then it is multiplied with float32 sums.
//
// What bounds it: at decode M (a few rows) the compressed weight bytes it
// streams (values + one index byte per value); at M = 2048 the kept
// values' multiply-adds, where this kernel, on the FMA units and not the
// tensor cores, stays far from the card's bf16 peak.  What the design
// does about it:
// * each weight byte is read once per row tile of X (8 rows at decode M,
//   64 above), coalesced across a tile's columns, several loads in flight
//   per thread;
// * at decode M the K tiles of each column tile are split across
//   `splits` blocks so that N / BN column tiles still fill the card; the
//   float32 partial sums are added in split order by a second kernel, so
//   results do not depend on scheduling.
// Not done yet: Hopper's 2:4 sparse tensor cores (mma.sp), TMA, double
// buffering.
//
// Grid: (N / BN, splits, ceil(M / RM)).  Any M >= 1: the ragged last row
// tile is masked.  BK <= 128 and a multiple of M; BN <= 128, BN % 32 == 0;
// 1 <= N <= 4, N <= M <= 8.

#include "tile_product.cuh"

namespace {

using tile::kThreads;
constexpr int kMaxGroup = 8;   // M
constexpr int kMaxKeep = 4;    // N

// Dense (BK, BN) tile kt, j of the weight into ws, rounded to XT.  Thread
// work item e is (group g, column c); its N kept values and offsets are
// read coalesced over c, and it writes the group's M dense rows.
template <typename XT, typename VT>
__device__ __forceinline__ void decompress(float* ws,
                                           const VT* __restrict__ values,
                                           const int8_t* __restrict__ idx,
                                           int bk, int bn, int n_keep,
                                           int m_group, int tid) {
  const int items = bk / m_group * bn;
  for (int e = tid; e < items; e += kThreads) {
    const int g = e / bn, c = e % bn;
    float v[kMaxKeep];
    int at[kMaxKeep];
#pragma unroll
    for (int i = 0; i < kMaxKeep; ++i) {
      const int src = (g * n_keep + i) * bn + c;
      v[i] = i < n_keep ? tile::to_f32<VT>(values[src]) : 0.f;
      at[i] = i < n_keep ? idx[src] : -1;
    }
#pragma unroll
    for (int p = 0; p < kMaxGroup; ++p) {
      if (p < m_group) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxKeep; ++i)
          if (at[i] == p) d += v[i];
        ws[(g * m_group + p) * bn + c] = tile::round_to<XT>(d);
      }
    }
  }
}

template <typename XT, typename VT, typename OT, int WR>
__global__ void __launch_bounds__(kThreads)
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
  if (splits > 1)
    tile::sum_splits<OT>(static_cast<const float*>(partial), out, splits,
                         static_cast<size_t>(m) * n, stream);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, typename VT, typename OT>
int launch_rows(int rows, const void* x, const void* values, const void* idx,
                void* out, void* partial, int m, int k, int n, int bk, int bn,
                int n_keep, int m_group, int splits, cudaStream_t stream) {
  return rows == tile::Shape<tile::kWarps>::RM
             ? launch<XT, VT, OT, tile::kWarps>(x, values, idx, out, partial,
                                                 m, k, n, bk, bn, n_keep,
                                                 m_group, splits, stream)
             : launch<XT, VT, OT, 1>(x, values, idx, out, partial, m, k, n,
                                     bk, bn, n_keep, m_group, splits, stream);
}

template <typename XT, typename VT>
int launch_out(int o_bf16, int rows, const void* x, const void* values,
               const void* idx, void* out, void* partial, int m, int k, int n,
               int bk, int bn, int n_keep, int m_group, int splits,
               cudaStream_t stream) {
  return o_bf16 ? launch_rows<XT, VT, __nv_bfloat16>(
                      rows, x, values, idx, out, partial, m, k, n, bk, bn,
                      n_keep, m_group, splits, stream)
                : launch_rows<XT, VT, float>(rows, x, values, idx, out,
                                             partial, m, k, n, bk, bn, n_keep,
                                             m_group, splits, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Type flags: 0 = float32,
// 1 = bfloat16.  `rows` is the row tile of X: 8 (decode M) or 64.
// `splits` > 1 splits the K tiles of each column tile over that many
// blocks; `partial` is then a float32 scratch buffer of
// splits x M x N.  Returns the launches' cudaGetLastError() (0 = success).
extern "C" int nm_spmm_launch(const void* x, const void* values,
                              const void* idx, void* out, void* partial,
                              int m, int k, int n, int bk, int bn, int n_keep,
                              int m_group, int splits, int rows, int x_bf16,
                              int v_bf16, int o_bf16, void* stream) {
  if (m < 1 || k < 1 || n < 1 || bk < 1 || bk > tile::kMaxBK || bn < 32 ||
      bn > tile::kMaxBN || bn % 32 != 0 || k % bk != 0 || n % bn != 0 ||
      m_group < 1 || m_group > kMaxGroup || n_keep < 1 || n_keep > kMaxKeep ||
      n_keep > m_group ||
      bk % m_group != 0 || splits < 1 || splits > 65535 ||
      (splits > 1 && partial == nullptr) || !tile::valid_rows(rows) ||
      (m + rows - 1) / rows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return v_bf16 ? launch_out<__nv_bfloat16, __nv_bfloat16>(
                        o_bf16, rows, x, values, idx, out, partial, m, k, n,
                        bk, bn, n_keep, m_group, splits, s)
                  : launch_out<__nv_bfloat16, float>(
                        o_bf16, rows, x, values, idx, out, partial, m, k, n,
                        bk, bn, n_keep, m_group, splits, s);
  return v_bf16 ? launch_out<float, __nv_bfloat16>(
                      o_bf16, rows, x, values, idx, out, partial, m, k, n, bk,
                      bn, n_keep, m_group, splits, s)
                : launch_out<float, float>(o_bf16, rows, x, values, idx, out,
                                           partial, m, k, n, bk, bn, n_keep,
                                           m_group, splits, s);
}
