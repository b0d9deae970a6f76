// Y(M, N) = X(M, K) . W with W stored in the paper's bitmap format.
//
// Replaces the TPU kernel src/repro/kernels/bitmap_spmm.py:bitmap_spmm
// (Pallas: `_kernel`, `_decompress_tile`).  W is tiled (BK, BN); per tile
// it holds the packed bitmap (BK rows of BN/8 bytes, little-endian within
// a byte), the non-zero values packed row by row into `budget` slots, and
// one start slot per row.  An element's value sits at
// clip(row_start[row] + rank, 0, budget - 1), rank = set bits before it in
// its row (the EIM re-sort).  Values are rounded to X's type before the
// product, as the reference casts its decompressed tile; sums are kept in
// float32.
//
// The grouped form (bitmap_spmm_grouped_launch) computes Y[g] = X[g] . W_g
// for a group-stacked W (MoE expert stacks: G experts, one shared value
// budget, so every group's leaves have the same stride).  It replaces
// src/repro/kernels/bitmap_spmm.py:bitmap_spmm_grouped, which unrolls G
// calls of the TPU kernel; here one launch covers every group.  K1 is the
// case G = 1.
//
// What bounds it: at decode M (1..8 rows) every weight byte feeds at most
// eight multiply-adds, far below the ~295 operations per byte where the
// H100 stops being bound by its memory, so the kernel is bound by the
// compressed weight bytes it streams (values + bitmap + row starts).
// What the design does about it:
// * The work is the flat list of weight tiles in the order (group, row
//   block of X, column tile, K tile), K fastest.  A persistent grid of as
//   many blocks as fit on the card splits it into near-equal ranges of
//   whole chunks (a chunk divides KT; the host picks the largest that
//   keeps the ranges within an eighth of equal), so the blocks stream
//   equal shares whatever the shape, and a near-empty stack keeps each
//   output tile's K range in one block.
// * Each block keeps a ring of 1 or 2 tile stages in shared memory.  A
//   stage is filled by the copy engine: bulk copies (cp.async.bulk) of
//   the tile's values, bitmap and row starts (16-byte-aligned windows
//   around them, so a budget % 4 != 0 needs no special case) and of the
//   X rows it multiplies, issued by lanes of warp 0 and completing on the
//   stage's mbarrier; no thread spends instructions on the copies.  The
//   host picks the block size (512 threads when a call has at most one
//   tile per SM, else 256) and the ring depth that puts the most blocks
//   on an SM: independent blocks overlap one another's loads, barriers
//   and walks better than a deeper ring in one block does.
// * Per tile, X's slice is widened to float32 [k][row], so one 16-byte
//   shared load gives four rows of X.  Dense walk: lane l owns columns
//   4l..4l+3; per row it reads its bitmap word and the word's first slot
//   (a table built once per tile), takes its nibble's first slot with one
//   popcount and the next three by adding bits, loads four values
//   (clamped slots) and adds each or a zero without a branch, two rows at
//   a time.  Sparse walk (budget <= BK x BN / 16): a ballot per bitmap
//   word lists the rows whose word is not zero, and the warp visits only
//   those, two at a time (lane l owns columns l + 32 j).  MR = 4 or 8
//   rows of X (a template parameter: the decode step's M = 4 does no
//   padding work); no conversion when X and the values share a type.
// * Once per output tile, not per tile: the warps' sums are added in warp
//   order through shared memory and written out, or, when the tile's K
//   range is split between blocks, written as a float32 partial; a
//   per-output-tile counter lets the last block to arrive add every
//   partial in block order and write the output (and reset the counter
//   for the next launch).  When every block walks one tile and an output
//   tile's K tiles are few (the host caps it at 12), its blocks are
//   launched as one thread block cluster and add their partials from
//   each other's shared memory in rank (K) order, with no trip through
//   device memory.  One launch per call, and the same bits in every run:
//   the order of every sum is fixed by the grid, not by scheduling.
// Not done yet: bf16 values (half the bytes; the format stores float32),
// the tensor cores for the walk's products, warp-specialised producers.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Threads per block, a runtime choice of the host's plan (a multiple of
// kMinThreads up to kMaxThreads): more warps walk a tile faster, more
// blocks per SM overlap one block's barriers and copies with another's.
constexpr int kMaxThreads = 512;
constexpr int kMinThreads = 128;
constexpr int kMaxStages = 2;
constexpr int kMaxCluster = 16;   // H100's largest (non-portable) cluster
constexpr int kMaxBK = 128;
constexpr int kMaxBN = 128;
// dynamic shared memory a block may ask for (the card's 227 KB less
// room for the static variables)
constexpr int kMaxDynBytes = 232448 - 1024;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// v as the product sees it: rounded to X's type, as float.
template <typename XT, typename VT>
__device__ __forceinline__ float weight(VT v) {
  if constexpr (sizeof(XT) == sizeof(VT)) {
    return to_f32<VT>(v);           // same type: no rounding
  } else if constexpr (sizeof(XT) == 2) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return to_f32<VT>(v);           // bf16 values are exact in float32
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The stages' copies are bulk copies (the copy engine, one thread issuing
// each contiguous range) completing on one mbarrier per stage.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nwait:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra wait;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// `bytes` (a multiple of 16) from src (16-byte aligned) to dst.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// The 16-byte window [src & ~15, round up(src + bytes, 16)): its byte
// count, and src's offset in it.  The window reads at most 15 bytes
// outside [src, src + bytes), inside the 16-byte granules that hold its
// first and last byte, so inside the allocation.
__device__ __forceinline__ uint32_t window(const void* src, int bytes,
                                           const void** start, int* head) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t a0 = a & ~uintptr_t{15};
  *start = reinterpret_cast<const void*>(a0);
  *head = static_cast<int>(a - a0);
  return static_cast<uint32_t>((a + bytes + 15 - a0) & ~uintptr_t{15});
}

struct Args {
  const void* x;             // (G, M, K), XT
  const uint8_t* bits;       // (G, KT, NT, BK, BN / 8)
  const void* values;        // (G, KT, NT, budget), VT
  const int32_t* row_start;  // (G, KT, NT, BK)
  void* out;                 // (G, M, N), bf16 if o_bf16 else float32
  float* partial;            // (2 x blocks, MR x BN) split output tiles
  int* counters;             // one per output tile, zero between launches
  const void* values_end;
  const uint8_t* bits_end;
  long long tiles;           // G x row blocks x NT x KT
  int chunk;                 // blocks' ranges are whole chunks of tiles
  int m, kt, nt, bk, bn, budget, row_blocks, o_bf16;
  int x_bulk;                // X's rows are 16-byte aligned: bulk copies
  int sparse;                // walk only the non-zero bitmap words
  int cluster;               // > 1: blocks of one output tile form a
                             // cluster and add their partials through
                             // distributed shared memory
  int stages, stage_bytes, off_bits, off_rs, off_x;   // the ring's layout
};

// First tile of block b's range (whole chunks of `chunk` tiles, which
// divides KT), and the block that holds tile t.
__device__ __forceinline__ long long range_start(const Args& a, int blocks,
                                                 int b) {
  return a.tiles / a.chunk * b / blocks * a.chunk;
}
__device__ __forceinline__ int block_of(const Args& a, int blocks,
                                        long long t) {
  return static_cast<int>(((t / a.chunk + 1) * blocks - 1) /
                          (a.tiles / a.chunk));
}

struct Tile {
  unsigned g, rb, nt, kt;
  unsigned o;   // output tile: (g x row blocks + rb) x NT + nt
};

// 32-bit division: the entry points refuse 2^31 tiles or more.
__device__ __forceinline__ Tile tile_of(const Args& a, long long t) {
  const unsigned tt = static_cast<unsigned>(t);
  Tile u;
  u.o = tt / a.kt;
  u.kt = tt - u.o * a.kt;
  const unsigned rest = u.o / a.nt;
  u.nt = u.o - rest * a.nt;
  u.g = rest / a.row_blocks;
  u.rb = rest - u.g * a.row_blocks;
  return u;
}

// Where tile u's leaves start.
__device__ __forceinline__ size_t weight_tile(const Args& a, const Tile& u) {
  return (static_cast<size_t>(u.g) * a.kt + u.kt) * a.nt + u.nt;
}

// Start tile u's copies into stage st: lanes of warp 0 each issue one
// bulk copy, all completing on `bar` (lane 0 first sets the bytes to
// expect): the values, bitmap and row starts by their 16-byte windows,
// and the MR rows of X it multiplies (those below M).  X rows that are
// not 16-byte aligned go through registers (every thread), visible after
// the next barrier.  The copy engine writes only the leaves' windows
// (and X in bulk mode), which no thread writes, so a barrier after the
// stage's last reads is all it needs before it writes the stage again.
template <typename XT, typename VT, int MR>
__device__ __forceinline__ void issue(const Args& a, const Tile& u,
                                      unsigned char* st, uint64_t* bar,
                                      int tid) {
  const int m0 = static_cast<int>(u.rb) * MR;
  const int rows = min(MR, a.m - m0);
  const size_t k = static_cast<size_t>(a.kt) * a.bk;
  const XT* x0 = static_cast<const XT*>(a.x) +
                 (static_cast<size_t>(u.g) * a.m + m0) * k +
                 static_cast<size_t>(u.kt) * a.bk;
  const int xrow = a.bk * static_cast<int>(sizeof(XT));
  if (tid < 32) {
    const size_t w = weight_tile(a, u);
    const int row_bytes = a.bn / 8;
    const void* src;
    int head, dst = a.off_x + (tid - 3) * xrow;
    uint32_t bytes = xrow;
    if (tid == 0) {
      bytes = window(static_cast<const VT*>(a.values) + w * a.budget,
                     a.budget * static_cast<int>(sizeof(VT)), &src, &head);
      dst = 0;
    } else if (tid == 1) {
      bytes = window(a.bits + w * a.bk * row_bytes, a.bk * row_bytes, &src,
                     &head);
      dst = a.off_bits;
    } else if (tid == 2) {
      bytes = window(a.row_start + w * a.bk, 4 * a.bk, &src, &head);
      dst = a.off_rs;
    } else {
      src = x0 + static_cast<size_t>(tid - 3) * k;
    }
    const bool copies = tid < 3 || (a.x_bulk && tid < 3 + rows);
    uint32_t total = __reduce_add_sync(0xffffffffu, copies ? bytes : 0u);
    if (tid == 0) mbar_expect(bar, total);
    __syncwarp();
    if (copies) bulk_copy(st + dst, src, bytes, bar);
  }
  if (!a.x_bulk) {
    XT* xs = reinterpret_cast<XT*>(st + a.off_x);
    for (int e = tid; e < rows * a.bk; e += blockDim.x) {
      const int i = e / a.bk;
      xs[e] = x0[i * k + (e - i * a.bk)];
    }
  }
}

// The stage's X slice (rows of X below M, row-major, in X's type) as
// float32 [c][i] into xf, zero past M; the caller synchronises before
// the walk reads it.
template <typename XT, int MR>
__device__ __forceinline__ void widen_x(float* xf, const unsigned char* xs,
                                        int bk, int rows, int tid) {
  const XT* x = reinterpret_cast<const XT*>(xs);
  for (int e = tid; e < MR * bk; e += blockDim.x) {
    const int i = e / bk, c = e - i * bk;
    xf[c * MR + i] = i < rows ? to_f32<XT>(x[e]) : 0.f;
  }
}

// The MR values of X (float32 [c][i]) that multiply row r of the tile.
template <int MR>
__device__ __forceinline__ void x_row(float (&xv)[MR], const float* xf,
                                      int r) {
#pragma unroll
  for (int i = 0; i < MR; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(xf + r * MR + i);
    xv[i] = v.x;
    xv[i + 1] = v.y;
    xv[i + 2] = v.z;
    xv[i + 3] = v.w;
  }
}

// One bitmap row of the stage's tile as four 32-bit words (bit l of word
// j: column l + 32 j), zero past BN.
__device__ __forceinline__ void row_words(uint32_t (&wd)[4],
                                          const uint8_t* bs, int r,
                                          int row_bytes, bool fast) {
  if (fast) {
    const uint4 v4 = *reinterpret_cast<const uint4*>(bs + r * 16);
    wd[0] = v4.x;
    wd[1] = v4.y;
    wd[2] = v4.z;
    wd[3] = v4.w;
    return;
  }
  const uint8_t* row = bs + r * row_bytes;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * j + i < row_bytes) word |= uint32_t{row[4 * j + i]} << (8 * i);
    wd[j] = word;
  }
}

// The stage's tile: its leaves in the stage (past their copy windows'
// heads) and whether its bitmap rows are whole aligned 16-byte words.
template <typename VT>
struct Leaves {
  const VT* vs;
  const uint8_t* bs;
  const int32_t* rs;
  bool fast;

  __device__ __forceinline__ Leaves(const Args& a, const Tile& u,
                                    const unsigned char* st) {
    const size_t w = weight_tile(a, u);
    const int row_bytes = a.bn / 8;
    const uintptr_t v = reinterpret_cast<uintptr_t>(
        static_cast<const VT*>(a.values) + w * a.budget);
    const uintptr_t b = reinterpret_cast<uintptr_t>(a.bits + w * a.bk *
                                                    row_bytes);
    const uintptr_t r = reinterpret_cast<uintptr_t>(a.row_start + w * a.bk);
    vs = reinterpret_cast<const VT*>(st + (v & 15u));
    bs = st + a.off_bits + (b & 15u);
    rs = reinterpret_cast<const int32_t*>(st + a.off_rs + (r & 15u));
    fast = row_bytes == 16 && (b & 15u) == 0;
  }
};

// Dense walk only: pre[r * 4 + j] = the slot of row r's first value in
// bitmap word j (its row start plus the set bits of the words before),
// one entry per thread, once per tile; the caller synchronises.
template <typename VT>
__device__ __forceinline__ void word_starts(int* pre, const Args& a,
                                            const Leaves<VT>& t, int tid) {
  for (int e = tid; e < 4 * a.bk; e += blockDim.x) {
    const int r = e >> 2, j = e & 3;
    uint32_t wd[4];
    row_words(wd, t.bs, r, a.bn / 8, t.fast);
    int s = t.rs[r];
#pragma unroll
    for (int q = 0; q < 3; ++q) s += q < j ? __popc(wd[q]) : 0;
    pre[e] = s;
  }
}

// acc[i][q] += X rows i . the stage's tile; xf is the tile's X slice as
// float32 [c][i].  Each lane adds its columns' products in row order
// within a warp, so the sums are the same in every run.
//
// Dense walk (acc[i][q]: column 4 x lane + q): warp w of W takes rows w,
// w + W, ..., two at a time.  A lane reads its bitmap word, its 4-bit
// nibble of it and its word's first slot (pre); one popcount gives the
// nibble's first slot, the next three follow by adding its bits.  It
// loads its four values (clamped slots, so always in the tile) and adds
// each, or a zero where its bit is clear, without a branch: a pair of
// rows keeps eight shared loads in flight, and the quarter-rate
// popcount and conversion units do five operations per row.
// Sparse walk (a.sparse: budget <= BK x BN / 16; acc[i][j]: column
// lane + 32 j): warp w takes the contiguous rows w x RW .. (RW = BK / W,
// at most 32); lane l loads row w x RW + l, and a ballot per word
// position lists the rows whose word is not zero; the warp visits only
// those, two at a time, in row order.
template <typename XT, typename VT, int MR>
__device__ __forceinline__ void walk(float (&acc)[MR][kMaxBN / 32],
                                     const Args& a, const Leaves<VT>& t,
                                     const int* pre, const float* xf,
                                     int warp, int lane) {
  const int nw = blockDim.x / 32, row_bytes = a.bn / 8;
  const int last = a.budget - 1;
  auto value = [&](int slot, bool set) {   // 0 where the bit is clear
    const float v = weight<XT, VT>(t.vs[min(max(slot, 0), last)]);
    return set ? v : 0.f;
  };
  if (a.sparse) {
    const uint32_t lane_bit = 1u << lane, below = lane_bit - 1u;
    const int rw = (a.bk + nw - 1) / nw, r0 = warp * rw;
    const int r = r0 + lane;
    uint32_t wd[4] = {0u, 0u, 0u, 0u};
    int start[4] = {0, 0, 0, 0};
    if (lane < rw && r < a.bk) {
      row_words(wd, t.bs, r, row_bytes, t.fast);
      start[0] = t.rs[r];
#pragma unroll
      for (int j = 1; j < 4; ++j) start[j] = start[j - 1] + __popc(wd[j - 1]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t rows = __ballot_sync(0xffffffffu, wd[j] != 0u);
      while (rows != 0u) {
        const int src0 = __ffs(rows) - 1;
        rows &= rows - 1u;
        const bool two = rows != 0u;
        const int src1 = two ? __ffs(rows) - 1 : src0;
        if (two) rows &= rows - 1u;
        const uint32_t w0 = __shfl_sync(0xffffffffu, wd[j], src0);
        const uint32_t w1 = two ? __shfl_sync(0xffffffffu, wd[j], src1) : 0u;
        const int s0 = __shfl_sync(0xffffffffu, start[j], src0);
        const int s1 = __shfl_sync(0xffffffffu, start[j], src1);
        float x0[MR], x1[MR];
        x_row<MR>(x0, xf, r0 + src0);
        x_row<MR>(x1, xf, r0 + src1);
        const float v0 = value(s0 + __popc(w0 & below), w0 & lane_bit);
        const float v1 = value(s1 + __popc(w1 & below), w1 & lane_bit);
#pragma unroll
        for (int i = 0; i < MR; ++i)
          acc[i][j] = fmaf(x1[i], v1, fmaf(x0[i], v0, acc[i][j]));
      }
    }
    return;
  }
  const int wi = lane >> 3, sh = (lane & 7) * 4;   // columns 4 lane .. + 3
  const uint32_t low = (1u << sh) - 1u;
  for (int r0 = warp; r0 < a.bk; r0 += 2 * nw) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + h * nw;
      if (r >= a.bk) break;
      uint32_t word;
      if (t.fast) {
        word = reinterpret_cast<const uint32_t*>(t.bs + r * 16)[wi];
      } else {
        uint32_t wd[4];
        row_words(wd, t.bs, r, row_bytes, false);
        word = wi == 0 ? wd[0] : wi == 1 ? wd[1] : wi == 2 ? wd[2] : wd[3];
      }
      const uint32_t nib = (word >> sh) & 15u;
      float xv[MR];
      x_row<MR>(xv, xf, r);
      const int s0 = pre[r * 4 + wi] + __popc(word & low);
      const int s1 = s0 + (nib & 1u), s2 = s1 + ((nib >> 1) & 1u);
      const int s3 = s2 + ((nib >> 2) & 1u);
      const float v[4] = {value(s0, nib & 1u), value(s1, nib & 2u),
                          value(s2, nib & 4u), value(s3, nib & 8u)};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < MR; ++i) acc[i][q] = fmaf(xv[i], v[q], acc[i][q]);
    }
  }
}

__device__ __forceinline__ void store(const Args& a, size_t at, float v) {
  if (a.o_bf16)
    static_cast<__nv_bfloat16*>(a.out)[at] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(a.out)[at] = v;
}

// Output tile u.o is done in this block (its last K tile, or the end of
// the block's range): add the warps' sums in warp order through `red`
// (four rows of X at a time) and write the output, or this block's
// partial and, if it is the last of the tile's blocks to arrive, the sum
// of every partial in block order.
template <int MR>
__device__ __forceinline__ void flush(float (&acc)[MR][kMaxBN / 32],
                                      const Args& a, const Tile& u,
                                      long long t_begin, long long t_end,
                                      float* red, float* part_s, int* last_s,
                                      int tid, int warp, int lane) {
  const int bn = a.bn, count = MR * bn, nth = blockDim.x;
  const int blocks = gridDim.x, b = blockIdx.x;
  const long long tb = static_cast<long long>(u.o) * a.kt;
  // the whole K range is this block's: no partial, no fold
  const bool whole = tb >= t_begin && tb + a.kt <= t_end;
  const int b0 = whole ? b : block_of(a, blocks, tb);
  const int b1 = whole ? b : block_of(a, blocks, tb + a.kt - 1);
  const int m0 = static_cast<int>(u.rb) * MR;
  const size_t n = static_cast<size_t>(a.nt) * bn;
  const size_t out0 = (static_cast<size_t>(u.g) * a.m + m0) * n +
                      static_cast<size_t>(u.nt) * bn;
  float* mine = a.cluster > 1
                    ? part_s
                    : a.partial + static_cast<size_t>(
                                      2 * b + (tb <= t_begin ? 0 : 1)) *
                                      count;
#pragma unroll
  for (int h = 0; h < MR; h += 4) {
    __syncthreads();   // red is free
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kMaxBN / 32; ++j) {
        const int c = a.sparse ? lane + 32 * j : 4 * lane + j;
        if (c < bn) red[(warp * 4 + i) * bn + c] = acc[h + i][j];
        acc[h + i][j] = 0.f;
      }
    __syncthreads();
    for (int e = tid; e < 4 * bn; e += nth) {
      const int i = e / bn, c = e - i * bn;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < nth / 32; ++w) sum += red[(w * 4 + i) * bn + c];
      if (b0 != b1)
        mine[(h + i) * bn + c] = sum;
      else if (m0 + h + i < a.m)
        store(a, out0 + (h + i) * n + c, sum);
    }
  }
  if (b0 == b1) return;   // the whole K range was this block's
  if (a.cluster > 1) {
    // one block per K tile of this output tile, rank = K tile: after the
    // cluster barrier each block adds its share of the elements over the
    // ranks' partials in rank order, then waits until every block is done
    // reading before any leaves
    namespace cg = cooperative_groups;
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    const int ranks = static_cast<int>(cl.num_blocks());
    for (int e = static_cast<int>(cl.block_rank()) * nth + tid; e < count;
         e += ranks * nth) {
      float sum = 0.f;
      for (int q = 0; q < ranks; q += 4) {
        float v[4];
#pragma unroll
        for (int d = 0; d < 4; ++d)
          v[d] = q + d < ranks ? cl.map_shared_rank(part_s, q + d)[e] : 0.f;
#pragma unroll
        for (int d = 0; d < 4; ++d)
          if (q + d < ranks) sum += v[d];
      }
      const int i = e / bn;
      if (m0 + i < a.m) store(a, out0 + i * n + (e - i * bn), sum);
    }
    cl.sync();
    return;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *last_s = atomicAdd(a.counters + u.o, 1) == b1 - b0;
  __syncthreads();
  if (!*last_s) return;
  __threadfence();
  // Block b0's partial is its first output tile's (slot 2 b0) when its
  // range starts at this tile, else its last's; every later block starts
  // inside this tile (slot 2 blk).  Each element's partials are loaded
  // four blocks at a time and added in block order.
  const float* first =
      a.partial +
      static_cast<size_t>(2 * b0 + (range_start(a, blocks, b0) == tb ? 0 : 1)) *
          count;
  const float* later = a.partial + static_cast<size_t>(2 * count) * b0;
  for (int e = tid; e < count; e += nth) {
    float sum = __ldcg(first + e);
    for (int blk = 1; blk <= b1 - b0; blk += 4) {
      float part[4];
#pragma unroll
      for (int d = 0; d < 4; ++d)
        part[d] = blk + d <= b1 - b0
                      ? __ldcg(later + static_cast<size_t>(2 * count) *
                                           (blk + d) + e)
                      : 0.f;
#pragma unroll
      for (int d = 0; d < 4; ++d)
        if (blk + d <= b1 - b0) sum += part[d];
    }
    const int i = e / bn;
    if (m0 + i < a.m) store(a, out0 + i * n + (e - i * bn), sum);
  }
  if (tid == 0) a.counters[u.o] = 0;   // ready for the next launch
}

template <typename XT, typename VT, int MR>
__global__ void __launch_bounds__(kMaxThreads, 1)
bitmap_spmm_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char dyn[];
  __shared__ int last_s;
  __shared__ __align__(8) uint64_t bars[kMaxStages];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = a.stages;
  const long long t_begin = range_start(a, gridDim.x, blockIdx.x);
  const int n = static_cast<int>(range_start(a, gridDim.x, blockIdx.x + 1) -
                                 t_begin);
  auto stage = [&](int i) {
    return dyn + static_cast<size_t>(i % S) * a.stage_bytes;
  };
  float* red = reinterpret_cast<float*>(dyn + static_cast<size_t>(S) *
                                                  a.stage_bytes);
  // the tile's X widened to float32 [c][i], after the warps' sums, then
  // the dense walk's word starts, then a cluster's partial sums
  float* xwide = red + blockDim.x / 32 * 4 * a.bn;
  int* pre = reinterpret_cast<int*>(xwide + MR * a.bk);
  float* part_s = reinterpret_cast<float*>(pre + 4 * a.bk);

  float acc[MR][kMaxBN / 32];
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int j = 0; j < kMaxBN / 32; ++j) acc[i][j] = 0.f;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // tiles in flight before the first wait: S - 1, or with one stage the
  // first tile (each next one is issued once the stage is walked)
  for (int s = 0; s < max(S - 1, 1) && s < n; ++s)
    issue<XT, VT, MR>(a, tile_of(a, t_begin + s), stage(s), bars + s, tid);
  for (int i = 0; i < n; ++i) {
    const int s = i % S;
    mbar_wait(bars + s, (i / S) & 1);   // tile i has landed
    __syncthreads();   // ... X too; every warp is past tile i - 1
    if (S > 1 && i + S - 1 < n) {       // into the stage tile i - 1 left
      const int s2 = (i + S - 1) % S;
      issue<XT, VT, MR>(a, tile_of(a, t_begin + i + S - 1), stage(s2),
                        bars + s2, tid);
    }
    const Tile u = tile_of(a, t_begin + i);
    const Leaves<VT> leaves(a, u, stage(s));
    widen_x<XT, MR>(xwide, stage(s) + a.off_x, a.bk,
                    min(MR, a.m - static_cast<int>(u.rb) * MR), tid);
    if (!a.sparse) word_starts<VT>(pre, a, leaves, tid);
    __syncthreads();
    walk<XT, VT, MR>(acc, a, leaves, pre, xwide, warp, lane);
    if (S == 1 && i + 1 < n) {   // the one stage is free once walked
      __syncthreads();
      issue<XT, VT, MR>(a, tile_of(a, t_begin + i + 1), stage(0), bars, tid);
    }
    if (u.kt == a.kt - 1 || i == n - 1)
      flush<MR>(acc, a, u, t_begin, t_begin + n, red, part_s, &last_s, tid,
                warp, lane);
  }
}

template <typename XT, typename VT, int MR>
void* kernel_of() {
  return reinterpret_cast<void*>(bitmap_spmm_kernel<XT, VT, MR>);
}

void* pick(int x_bf16, int v_bf16, int rows) {
  using bf = __nv_bfloat16;
  if (rows != 4 && rows != 8) return nullptr;
  const bool four = rows == 4;
  if (x_bf16)
    return v_bf16 ? (four ? kernel_of<bf, bf, 4>() : kernel_of<bf, bf, 8>())
                  : (four ? kernel_of<bf, float, 4>()
                          : kernel_of<bf, float, 8>());
  return v_bf16 ? (four ? kernel_of<float, bf, 4>()
                        : kernel_of<float, bf, 8>())
                : (four ? kernel_of<float, float, 4>()
                        : kernel_of<float, float, 8>());
}

// Every variant may take up to kMaxDynBytes of dynamic shared memory and
// clusters of up to kMaxCluster blocks (set once per variant).
cudaError_t configure(void* fn, int x_bf16, int v_bf16, int rows) {
  static cudaError_t done[8] = {cudaErrorNotReady, cudaErrorNotReady,
                                cudaErrorNotReady, cudaErrorNotReady,
                                cudaErrorNotReady, cudaErrorNotReady,
                                cudaErrorNotReady, cudaErrorNotReady};
  cudaError_t& rc = done[4 * (x_bf16 != 0) + 2 * (v_bf16 != 0) + (rows == 8)];
  if (rc != cudaSuccess) {
    rc = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxDynBytes);
    if (rc == cudaSuccess)
      rc = cudaFuncSetAttribute(
          fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return rc;
}

// A launch of `blocks` blocks in clusters of `cluster` (1: none); the
// caller points attrs at the cluster dimension.
cudaLaunchConfig_t launch_config(int blocks, int threads, int smem,
                                 int cluster, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cfg;
}

int dispatch(const void* x, const void* bits, const void* values,
             const void* row_start, void* out, void* partial, void* counters,
             int groups, int m, int kt, int nt, int bk, int bn, int budget,
             int rows, int threads, int blocks, int cluster, int chunk,
             int stages,
             int stage_bytes, int off_bits, int off_rs, int off_x, int smem,
             int x_bulk, int x_bf16, int v_bf16, int o_bf16, void* stream) {
  void* fn = pick(x_bf16, v_bf16, rows);
  const long long row_blocks = (m + rows - 1) / rows;
  const long long tiles = groups * row_blocks * nt * kt;
  // the warps' sums, X widened to float32, the word starts, the partial
  const long long red = 4LL * (threads / 32) * 4 * bn + 4LL * rows * bk +
                        16LL * bk + 4LL * rows * bn;
  if (fn == nullptr || threads % kMinThreads != 0 || threads > kMaxThreads ||
      tiles >= (1ll << 31) || groups < 1 || m < 1 || kt < 1 || nt < 1 ||
      bk < 1 || bk > kMaxBK || bn < 8 || bn > kMaxBN || bn % 8 != 0 ||
      budget < 1 || budget > kMaxBK * kMaxBN || chunk < 1 || kt % chunk != 0 ||
      blocks < 1 || blocks > tiles / chunk || stages < 1 ||
      stages > kMaxStages || stage_bytes % 16 != 0 || off_x % 16 != 0 ||
      off_x + static_cast<long long>(rows) * bk * (x_bf16 ? 2 : 4) >
          stage_bytes ||
      smem > kMaxDynBytes ||
      static_cast<long long>(stages) * stage_bytes + red > smem ||
      counters == nullptr || cluster < 1 || cluster > kMaxCluster ||
      (cluster > 1 && (chunk != 1 || blocks != tiles || kt != cluster)) ||
      (blocks > 1 && cluster == 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t configured = configure(fn, x_bf16, v_bf16, rows);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const int vsize = v_bf16 ? 2 : 4;
  const size_t leaves = static_cast<size_t>(groups) * kt * nt;
  Args a;
  a.x = x;
  a.bits = static_cast<const uint8_t*>(bits);
  a.values = values;
  a.row_start = static_cast<const int32_t*>(row_start);
  a.out = out;
  a.partial = static_cast<float*>(partial);
  a.counters = static_cast<int*>(counters);
  a.values_end = static_cast<const unsigned char*>(values) +
                 leaves * budget * vsize;
  a.bits_end = a.bits + leaves * bk * (bn / 8);
  a.tiles = tiles;
  a.chunk = chunk;
  a.x_bulk = x_bulk;
  a.sparse = 16LL * budget <= static_cast<long long>(bk) * bn;
  a.cluster = cluster;
  a.m = m;
  a.kt = kt;
  a.nt = nt;
  a.bk = bk;
  a.bn = bn;
  a.budget = budget;
  a.row_blocks = static_cast<int>(row_blocks);
  a.o_bf16 = o_bf16;
  a.stages = stages;
  a.stage_bytes = stage_bytes;
  a.off_bits = off_bits;
  a.off_rs = off_rs;
  a.off_x = off_x;
  void* args[] = {&a};
  cudaLaunchConfig_t cfg = launch_config(blocks, threads, smem, cluster,
                                         static_cast<cudaStream_t>(stream));
  cudaLaunchAttribute dims;
  dims.id = cudaLaunchAttributeClusterDimension;
  dims.val.clusterDim.x = cluster;
  dims.val.clusterDim.y = 1;
  dims.val.clusterDim.z = 1;
  cfg.attrs = &dims;
  const cudaError_t rc = cudaLaunchKernelExC(&cfg, fn, args);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Type flags: 0 = float32,
// 1 = bfloat16.  The host plans the call (kernels/bitmap_spmm.py:
// stream_plan): `rows` (4 or 8) rows of X per tile, `blocks` persistent
// blocks of `threads` (256 or 512) threads, each a range of whole chunks
// of `chunk` tiles (chunk divides
// KT; at most one block per chunk), a ring of `stages` stages of
// `stage_bytes` (offsets of the bitmap, row starts and X within one),
// then the warps' sums and X widened to float32: `smem` bytes of dynamic
// shared memory in all.
// `x_bulk`: X's rows within a tile are 16-byte aligned and a multiple of
// 16 bytes, so they go by bulk copies.  `cluster` > 1 (= KT, with one
// tile per block): the blocks of an output tile form a cluster and add
// their partials through distributed shared memory, with no `partial`
// scratch and no counter.
// `partial` is float32 scratch of 2 x blocks x rows x BN (unused when
// blocks == 1), `counters` one int per output tile (G x ceil(M / rows) x
// NT), zero before the launch and zero again after it.  Each returns the
// launch's cudaGetLastError() (0 = success).
extern "C" int bitmap_spmm_launch(
    const void* x, const void* bits, const void* values, const void* row_start,
    void* out, void* partial, void* counters, int m, int kt, int nt, int bk,
    int bn, int budget, int rows, int threads, int blocks, int cluster,
    int chunk, int stages, int stage_bytes, int off_bits, int off_rs,
    int off_x, int smem, int x_bulk, int x_bf16, int v_bf16, int o_bf16,
    void* stream) {
  return dispatch(x, bits, values, row_start, out, partial, counters, 1, m,
                  kt, nt, bk, bn, budget, rows, threads, blocks, cluster,
                  chunk, stages, stage_bytes, off_bits, off_rs, off_x, smem,
                  x_bulk, x_bf16, v_bf16, o_bf16, stream);
}

// Y[g] = X[g] . W_g for g < groups: X (G, M, K), Y (G, M, N), the weight's
// leaves (G, KT, NT, ...) with one budget for the whole stack.
extern "C" int bitmap_spmm_grouped_launch(
    const void* x, const void* bits, const void* values, const void* row_start,
    void* out, void* partial, void* counters, int groups, int m, int kt,
    int nt, int bk, int bn, int budget, int rows, int threads, int blocks,
    int cluster, int chunk, int stages, int stage_bytes, int off_bits,
    int off_rs, int off_x, int smem, int x_bulk, int x_bf16, int v_bf16,
    int o_bf16, void* stream) {
  return dispatch(x, bits, values, row_start, out, partial, counters, groups,
                  m, kt, nt, bk, bn, budget, rows, threads, blocks, cluster,
                  chunk, stages, stage_bytes, off_bits, off_rs, off_x, smem,
                  x_bulk, x_bf16, v_bf16, o_bf16, stream);
}

// Blocks of one K1/K1g variant of `threads` threads that fit on an SM
// with `smem` bytes of dynamic shared memory (the wrapper sizes the
// persistent grid by it), or a negative CUDA error.
extern "C" int bitmap_spmm_blocks_per_sm(int x_bf16, int v_bf16, int rows,
                                         int threads, int smem) {
  void* fn = pick(x_bf16, v_bf16, rows);
  if (fn == nullptr || smem < 0 || smem > kMaxDynBytes ||
      threads % kMinThreads != 0 || threads > kMaxThreads)
    return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = configure(fn, x_bf16, v_bf16, rows);
  int blocks = 0;
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                       smem);
  return rc == cudaSuccess ? blocks : -static_cast<int>(rc);
}

// Clusters of `cluster` blocks of one K1/K1g variant (`threads` threads,
// `smem` bytes of dynamic shared memory each) that can be resident on the
// card at once, or a negative CUDA error.
extern "C" int bitmap_spmm_clusters(int x_bf16, int v_bf16, int rows,
                                    int threads, int smem, int cluster) {
  void* fn = pick(x_bf16, v_bf16, rows);
  if (fn == nullptr || smem < 0 || smem > kMaxDynBytes || cluster < 1 ||
      cluster > kMaxCluster || threads % kMinThreads != 0 ||
      threads > kMaxThreads)
    return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = configure(fn, x_bf16, v_bf16, rows);
  int clusters = 0;
  if (rc == cudaSuccess) {
    cudaLaunchConfig_t cfg =
        launch_config(cluster, threads, smem, cluster, nullptr);
    cudaLaunchAttribute dims;
    dims.id = cudaLaunchAttributeClusterDimension;
    dims.val.clusterDim.x = cluster;
    dims.val.clusterDim.y = 1;
    dims.val.clusterDim.z = 1;
    cfg.attrs = &dims;
    cfg.numAttrs = 1;
    rc = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  }
  return rc == cudaSuccess ? clusters : -static_cast<int>(rc);
}
