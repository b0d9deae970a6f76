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
//
// What bounds it: at decode M (a few rows) each weight byte feeds at most
// a few multiply-adds, so the kernel is bound by the surviving blocks'
// bytes it streams; at M = 2048 it is bound by operations (the surviving
// blocks' multiply-adds, about 2 x M per weight element), where this
// kernel, using the FMA units and not the tensor cores, stays far from
// the card's bf16 peak.  What the design does about it:
// * each surviving block is read once per row tile of X (8 rows at decode
//   M, 64 above), with 16-byte loads, several in flight per thread;
// * at decode M only N / BN column blocks exist (64 for olmo-1b's gate/up
//   on 132 SMs), so the surviving-block loop of each column block is
//   split across `splits` blocks, each taking an equal share of that
//   column's nnzb[j] blocks (balanced by surviving blocks, not by K);
//   the float32 partial sums are added in split order by a second kernel,
//   so results do not depend on scheduling;
// * the all-zero blocks are neither read nor multiplied.
// Not done yet: tensor cores (mma / wgmma), TMA, double buffering.
//
// Grid: (N / BN, splits, ceil(M / RM)).  Any M >= 1: the ragged last row
// tile is masked, with no padding of X.  BK <= 128, BN <= 128, BN % 32 == 0.

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
  if (splits > 1)
    tile::sum_splits<OT>(static_cast<const float*>(partial), out, splits,
                         static_cast<size_t>(m) * n, stream);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, typename VT, typename OT>
int launch_rows(int rows, const void* x, const void* values, const void* kidx,
                const void* nnzb, void* out, void* partial, int m, int k,
                int n, int bk, int bn, int smax, int splits,
                cudaStream_t stream) {
  return rows == tile::Shape<tile::kWarps>::RM
             ? launch<XT, VT, OT, tile::kWarps>(x, values, kidx, nnzb, out,
                                                 partial, m, k, n, bk, bn,
                                                 smax, splits, stream)
             : launch<XT, VT, OT, 1>(x, values, kidx, nnzb, out, partial, m,
                                     k, n, bk, bn, smax, splits, stream);
}

template <typename XT, typename VT>
int launch_out(int o_bf16, int rows, const void* x, const void* values,
               const void* kidx, const void* nnzb, void* out, void* partial,
               int m, int k, int n, int bk, int bn, int smax, int splits,
               cudaStream_t stream) {
  return o_bf16
             ? launch_rows<XT, VT, __nv_bfloat16>(rows, x, values, kidx, nnzb,
                                                  out, partial, m, k, n, bk,
                                                  bn, smax, splits, stream)
             : launch_rows<XT, VT, float>(rows, x, values, kidx, nnzb, out,
                                          partial, m, k, n, bk, bn, smax,
                                          splits, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Type flags: 0 = float32,
// 1 = bfloat16.  `rows` is the row tile of X: 8 (decode M) or 64.
// `splits` > 1 shares each column block's surviving blocks among that
// many thread blocks; `partial` is then a float32 scratch buffer of
// splits x M x N.  Returns the launches' cudaGetLastError() (0 = success).
extern "C" int block_sparse_launch(const void* x, const void* values,
                                   const void* kidx, const void* nnzb,
                                   void* out, void* partial, int m, int k,
                                   int n, int bk, int bn, int smax, int splits,
                                   int rows, int x_bf16, int v_bf16,
                                   int o_bf16, void* stream) {
  if (m < 1 || k < 1 || n < 1 || bk < 1 || bk > tile::kMaxBK || bn < 32 ||
      bn > tile::kMaxBN || bn % 32 != 0 || k % bk != 0 || n % bn != 0 ||
      smax < 1 || splits < 1 || splits > 65535 ||
      (splits > 1 && partial == nullptr) || !tile::valid_rows(rows) ||
      (m + rows - 1) / rows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return v_bf16 ? launch_out<__nv_bfloat16, __nv_bfloat16>(
                        o_bf16, rows, x, values, kidx, nnzb, out, partial, m,
                        k, n, bk, bn, smax, splits, s)
                  : launch_out<__nv_bfloat16, float>(
                        o_bf16, rows, x, values, kidx, nnzb, out, partial, m,
                        k, n, bk, bn, smax, splits, s);
  return v_bf16 ? launch_out<float, __nv_bfloat16>(o_bf16, rows, x, values,
                                                   kidx, nnzb, out, partial, m,
                                                   k, n, bk, bn, smax, splits,
                                                   s)
                : launch_out<float, float>(o_bf16, rows, x, values, kidx, nnzb,
                                           out, partial, m, k, n, bk, bn, smax,
                                           splits, s);
}
