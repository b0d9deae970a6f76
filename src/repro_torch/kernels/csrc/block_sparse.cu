// Y(M, N) = X(M, K) . W with W block-sparse: all-zero (BK, BN) blocks
// dropped at pack time.
//
// Replaces the TPU kernel src/repro/kernels/block_sparse.py:
// block_sparse_matmul (Pallas: `_kernel`, scalar-prefetched `kidx` /
// `nnzb`).  Per column block j the weight keeps nnzb[j] surviving blocks,
// values[j, s] (BK x BN) taken from K block kidx[j, s], s < nnzb[j]; the
// rest of the SMAX slots are padding.  Each block of threads loads its
// own indices (the TPU grid prefetched them) and multiplies only the
// surviving blocks: X's K block kidx[j, s] against values[j, s].  The
// weight is rounded to X's type before the product, as the plain version
// (`block_sparse_matmul_ref`) casts its dense weight; sums are float32.
// Column blocks with nnzb[j] == 0 store zeros; the all-zero blocks are
// neither read nor multiplied.
//
// Three paths, picked by the host per call (kernels/tile_product.py:
// plan; the shared pieces are in tile_product.cuh):
// * Wide M, bf16 X (128-row tiles): bound by the surviving blocks'
//   multiply-adds (2 x M per weight element).  Tensor cores: each
//   surviving block values[j, s] and X's K block kidx[j, s] go straight
//   into a three-stage shared-memory ring by cp.async (the data-dependent
//   X address is why cp.async fits), 128 / BK blocks per 128-deep stage,
//   one mma.sync K loop over them; float32 values are rounded to bf16 as
//   they are staged, from registers loaded one stage ahead.  At M = 2048
//   every olmo-1b shape has enough blocks, so the surviving-block loop
//   is not split.
// * Decode M, bf16 X (8-row tiles): bound by the surviving blocks' bytes.
//   A two-stage ring (so that three blocks fit on an SM) and mma.sync on
//   16-row A fragments whose rows 8-15 are zero registers; the warps
//   share each stage's 16-deep steps and add their sums in a fixed order.
//   Only N / BN column blocks exist (64 for olmo-1b's gate/up on 132
//   SMs), so each column block's surviving blocks are split across
//   `splits` thread blocks in equal shares (balanced by surviving blocks,
//   not by K), and the float32 partial sums are added in split order by a
//   second kernel, so results do not depend on scheduling.
// * float32 X (or BK not 16, 32, 64, 128): the FMA path, 8- or 64-row
//   tiles, split as at decode M.
// Not done yet: wgmma with TMA loads of the surviving blocks (the next
// step for this kernel: mma.sync keeps it at 10-15 % of the bf16 peak),
// a warp-specialised producer.
//
// Grid: (N / BN, splits, ceil(M / RM)).  Any M >= 1: the ragged last row
// tile is masked (zero rows in shared memory, no store past M), with no
// padding of X.  BK <= 128, BN <= 128, BN % 32 == 0.

#include "tile_product.cuh"

namespace {

using tile::kThreads;

template <typename XT, typename VT, typename OT, int WR>
__global__ void __launch_bounds__(kThreads)
block_sparse_kernel(const XT* __restrict__ x, const VT* __restrict__ values,
                    const int32_t* __restrict__ kidx,
                    const int32_t* __restrict__ nnzb, OT* __restrict__ out,
                    float* __restrict__ partial, int m, int k, int n, int bk,
                    int bn, int smax, int splits) {
  extern __shared__ __align__(16) float smem[];
  using S = tile::Shape<WR>;
  float* xs = smem;
  float* ws = smem + bk * S::XS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = blockIdx.x, split = blockIdx.y, m0 = blockIdx.z * S::RM;
  const int kt = k / bk;
  // this split's share of column block j's surviving blocks
  const int count = min(max(nnzb[j], 0), smax);
  const int per = (count + splits - 1) / splits;
  const int s0 = min(split * per, count), s1 = min(s0 + per, count);

  float acc[8][tile::kMaxCJ] = {};
  for (int s = s0; s < s1; ++s) {
    const int kb = min(max(kidx[j * smax + s], 0), kt - 1);
    tile::stage_x<XT, WR>(xs, x, m, k, m0, kb * bk, bk, tid);
    tile::stage_w<XT, VT>(
        ws, values + (static_cast<size_t>(j) * smax + s) * bk * bn, bk * bn,
        tid);
    __syncthreads();
    tile::mac<WR>(acc, xs, ws, bk, bn, warp, lane);
    __syncthreads();
  }
  tile::store<WR, OT>(acc, ws, out, splits > 1 ? partial : nullptr, split,
                      m, n, m0, j * bn, bn, warp, lane, tid);
}


// Weight producers of the tensor-core path: step i's surviving blocks
// s0 + i x ks + t, t < ks (ks = tc::stacked(BK)), of column block j into
// rows t x BK .. of a bf16 weight stage (row stride BN + kPad); zeros
// past the last of the n blocks.
template <typename VT>
struct BlockStage;

template <>   // bf16 values: cp.async, 16 bytes at a time
struct BlockStage<__nv_bfloat16> {
  const __nv_bfloat16* values;   // column block j's slots
  const int32_t* kidx;           // column block j's K block indices
  int s0, n, bk, bn, kt, tid;
  __device__ int k0(int t) const {
    return min(max(kidx[s0 + t], 0), kt - 1) * bk;
  }
  __device__ void fetch(int i, __nv_bfloat16* ws) {
    const int ks = tc::stacked(bk), chunks = bn / 8;
    const tc::Div cdiv(chunks), rdiv(bk);
    for (int e = tid; e < ks * bk * chunks; e += kThreads) {
      const int row = cdiv.div(e), col = (e - row * chunks) * 8;
      const int sub = rdiv.div(row), t = i * ks + sub;
      const bool valid = t < n;
      tc::cp_async16(ws + row * (bn + tc::kPad) + col,
                     valid ? values + static_cast<size_t>(s0 + t) * bk * bn +
                                 (row - sub * bk) * bn + col
                           : values,
                     valid);
    }
  }
  __device__ void put(__nv_bfloat16*) {}
};

template <>   // float32 values: into registers, rounded to bf16 on the way out
struct BlockStage<float> {
  // thread tid loads 16 bytes at column 4 x (tid % quads) of rows
  // tid / quads + u x (256 / quads), u < kLoads
  static constexpr int kLoads = 16;
  const float* values;
  const int32_t* kidx;
  int s0, n, bk, bn, kt, tid;
  uint4 r[kLoads];
  __device__ int k0(int t) const {
    return min(max(kidx[s0 + t], 0), kt - 1) * bk;
  }
  __device__ void fetch(int i, __nv_bfloat16*) {
    const int quads = bn / 4, pass = kThreads / quads, ks = tc::stacked(bk);
    const int row0 = tid / quads, col = (tid - row0 * quads) * 4;
    const tc::Div rdiv(bk);
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int row = row0 + u * pass, sub = rdiv.div(row), t = i * ks + sub;
      r[u] = tid < pass * quads && row < ks * bk && t < n
                 ? __ldg(reinterpret_cast<const uint4*>(
                       values + static_cast<size_t>(s0 + t) * bk * bn +
                       (row - sub * bk) * bn + col))
                 : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __device__ void put(__nv_bfloat16* ws) {
    const int quads = bn / 4, pass = kThreads / quads;
    const int row0 = tid / quads, col = (tid - row0 * quads) * 4;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int row = row0 + u * pass;
      if (tid >= pass * quads || row >= tc::stage_depth(bk)) continue;
      *reinterpret_cast<uint2*>(ws + row * (bn + tc::kPad) + col) = make_uint2(
          tc::pack_bf16(__uint_as_float(r[u].x), __uint_as_float(r[u].y)),
          tc::pack_bf16(__uint_as_float(r[u].z), __uint_as_float(r[u].w)));
    }
  }
};

template <typename VT, typename OT, bool WIDE>
__device__ __forceinline__ void block_sparse_tc(
    const __nv_bfloat16* __restrict__ x, const VT* __restrict__ values,
    const int32_t* __restrict__ kidx, const int32_t* __restrict__ nnzb,
    OT* __restrict__ out, float* __restrict__ partial, int m, int k, int n,
    int bk, int bn, int smax, int splits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = blockIdx.x, split = blockIdx.y;
  const int m0 = blockIdx.z * tc::Layout<WIDE>::RM;
  const int count = min(max(nnzb[j], 0), smax);
  const int per = (count + splits - 1) / splits;
  const int s0 = min(split * per, count), s1 = min(s0 + per, count);
  BlockStage<VT> w{values + static_cast<size_t>(j) * smax * bk * bn,
                   kidx + static_cast<size_t>(j) * smax, s0, s1 - s0, bk, bn,
                   k / bk, tid};
  const tc::WarpTile wt = tc::warp_tile<WIDE>(warp, tc::stage_depth(bk), bn);
  tc::Acc<WIDE> acc = {};
  tc::mainloop<WIDE>(acc, smem, x, m, k, m0, bk, bn, s1 - s0, w, wt, tid,
                     lane);
  tc::store<WIDE, OT>(acc, smem, out, splits > 1 ? partial : nullptr, split,
                      m, n, m0, j * bn, tc::stage_depth(bk), bn, wt, tid,
                      lane);
}

// Separate names, so that the SASS of each path can be told apart.
template <typename VT, typename OT>
__global__ void __launch_bounds__(kThreads, 1)
block_sparse_mma_wide(const __nv_bfloat16* __restrict__ x,
                      const VT* __restrict__ values,
                      const int32_t* __restrict__ kidx,
                      const int32_t* __restrict__ nnzb, OT* __restrict__ out,
                      float* __restrict__ partial, int m, int k, int n, int bk,
                      int bn, int smax, int splits) {
  block_sparse_tc<VT, OT, true>(x, values, kidx, nnzb, out, partial, m, k, n,
                                bk, bn, smax, splits);
}

template <typename VT, typename OT>
__global__ void __launch_bounds__(kThreads)
block_sparse_mma_decode(const __nv_bfloat16* __restrict__ x,
                        const VT* __restrict__ values,
                        const int32_t* __restrict__ kidx,
                        const int32_t* __restrict__ nnzb,
                        OT* __restrict__ out, float* __restrict__ partial,
                        int m, int k, int n, int bk, int bn, int smax,
                        int splits) {
  block_sparse_tc<VT, OT, false>(x, values, kidx, nnzb, out, partial, m, k,
                                 n, bk, bn, smax, splits);
}

template <typename XT, typename VT, typename OT, int WR>
int launch(const void* x, const void* values, const void* kidx,
           const void* nnzb, void* out, void* partial, int m, int k, int n,
           int bk, int bn, int smax, int splits, cudaStream_t stream) {
  auto kernel = block_sparse_kernel<XT, VT, OT, WR>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tile::smem_bytes<WR>(tile::kMaxBK, tile::kMaxBN));
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const int rm = tile::Shape<WR>::RM;
  const dim3 grid(n / bn, splits, (m + rm - 1) / rm);
  kernel<<<grid, kThreads, tile::smem_bytes<WR>(bk, bn), stream>>>(
      static_cast<const XT*>(x), static_cast<const VT*>(values),
      static_cast<const int32_t*>(kidx), static_cast<const int32_t*>(nnzb),
      static_cast<OT*>(out), static_cast<float*>(partial), m, k, n, bk, bn,
      smax, splits);
  return 0;
}

template <typename VT, typename OT, bool WIDE>
int launch_tc(const void* x, const void* values, const void* kidx,
              const void* nnzb, void* out, void* partial, int m, int k, int n,
              int bk, int bn, int smax, int splits, cudaStream_t stream) {
  auto kernel = WIDE ? block_sparse_mma_wide<VT, OT>
                     : block_sparse_mma_decode<VT, OT>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tc::smem_bytes<WIDE>(tile::kMaxBK, tile::kMaxBN));
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const int rm = tc::Layout<WIDE>::RM;
  const dim3 grid(n / bn, splits, (m + rm - 1) / rm);
  kernel<<<grid, kThreads, tc::smem_bytes<WIDE>(bk, bn), stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const VT*>(values),
      static_cast<const int32_t*>(kidx), static_cast<const int32_t*>(nnzb),
      static_cast<OT*>(out), static_cast<float*>(partial), m, k, n, bk, bn,
      smax, splits);
  return 0;
}

// One call on `path` (0 = FMA, 1 = tensor cores at wide M, 2 = tensor
// cores at decode M) with the row tile `rows`.
template <typename XT, typename VT, typename OT>
int launch_path(int path, int rows, const void* x, const void* values,
                const void* kidx, const void* nnzb, void* out, void* partial,
                int m, int k, int n, int bk, int bn, int smax, int splits,
                cudaStream_t stream) {
  int rc = static_cast<int>(cudaErrorInvalidValue);
  if constexpr (sizeof(XT) == 2) {
    if (path == 1)
      rc = launch_tc<VT, OT, true>(x, values, kidx, nnzb, out, partial, m, k,
                                   n, bk, bn, smax, splits, stream);
    else if (path == 2)
      rc = launch_tc<VT, OT, false>(x, values, kidx, nnzb, out, partial, m,
                                    k, n, bk, bn, smax, splits, stream);
  }
  if (path == 0)
    rc = rows == tile::Shape<tile::kWarps>::RM
             ? launch<XT, VT, OT, tile::kWarps>(x, values, kidx, nnzb, out,
                                                 partial, m, k, n, bk, bn,
                                                 smax, splits, stream)
             : launch<XT, VT, OT, 1>(x, values, kidx, nnzb, out, partial, m,
                                     k, n, bk, bn, smax, splits, stream);
  if (rc != 0) return rc;
  if (splits > 1)
    tile::sum_splits<OT>(static_cast<const float*>(partial), out, splits,
                         static_cast<size_t>(m) * n, stream);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, typename VT>
int launch_out(int o_bf16, int path, int rows, const void* x,
               const void* values, const void* kidx, const void* nnzb,
               void* out, void* partial, int m, int k, int n, int bk, int bn,
               int smax, int splits, cudaStream_t stream) {
  return o_bf16 ? launch_path<XT, VT, __nv_bfloat16>(
                      path, rows, x, values, kidx, nnzb, out, partial, m, k,
                      n, bk, bn, smax, splits, stream)
                : launch_path<XT, VT, float>(path, rows, x, values, kidx,
                                             nnzb, out, partial, m, k, n, bk,
                                             bn, smax, splits, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Type flags: 0 = float32,
// 1 = bfloat16.  `path` 0 is the FMA path with the row tile `rows` 8
// (decode M) or 64; path 1 the tensor cores at wide M (rows 128), path 2
// at decode M (rows 8), both for bfloat16 X only, BK dividing 128 and X
// 16-byte aligned.  `splits` > 1 shares each column block's surviving
// blocks among that many thread blocks; `partial` is then a float32
// scratch buffer of splits x M x N.  Returns the launches'
// cudaGetLastError() (0 = success).
extern "C" int block_sparse_launch(const void* x, const void* values,
                                   const void* kidx, const void* nnzb,
                                   void* out, void* partial, int m, int k,
                                   int n, int bk, int bn, int smax, int splits,
                                   int path, int rows, int x_bf16, int v_bf16,
                                   int o_bf16, void* stream) {
  const bool tc_path = path == 1 || path == 2;
  const bool rows_ok =
      path == 0 ? tile::valid_rows(rows)
                : tc_path && rows == (path == 1 ? tc::Layout<true>::RM
                                                : tc::Layout<false>::RM);
  if (m < 1 || k < 1 || n < 1 || bk < 1 || bk > tile::kMaxBK || bn < 32 ||
      bn > tile::kMaxBN || bn % 32 != 0 || k % bk != 0 || n % bn != 0 ||
      smax < 1 || splits < 1 || splits > 65535 ||
      (splits > 1 && partial == nullptr) || !rows_ok ||
      (m + rows - 1) / rows > 65535 ||
      (tc_path && (!x_bf16 || bk % 16 != 0 || 128 % bk != 0 ||
                   reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
                   reinterpret_cast<uintptr_t>(values) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return v_bf16 ? launch_out<__nv_bfloat16, __nv_bfloat16>(
                        o_bf16, path, rows, x, values, kidx, nnzb, out,
                        partial, m, k, n, bk, bn, smax, splits, s)
                  : launch_out<__nv_bfloat16, float>(
                        o_bf16, path, rows, x, values, kidx, nnzb, out,
                        partial, m, k, n, bk, bn, smax, splits, s);
  return v_bf16 ? launch_out<float, __nv_bfloat16>(
                      o_bf16, path, rows, x, values, kidx, nnzb, out, partial,
                      m, k, n, bk, bn, smax, splits, s)
                : launch_out<float, float>(o_bf16, path, rows, x, values,
                                           kidx, nnzb, out, partial, m, k, n,
                                           bk, bn, smax, splits, s);
}
