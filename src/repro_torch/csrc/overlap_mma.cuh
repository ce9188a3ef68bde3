// overlap_mma — the overlap counting kernel on Hopper's tensor cores.
//
// Replaces four TPU kernels of the JAX package, one mode (kMode) each:
//   src/repro/kernels/support_count.py:_support_count_kernel and
//   src/repro/kernels/support_count.py:_support_count_matmul_kernel
//     (kBits) a = candidate words, b = transaction words, each product the
//     AND-popcount of single bits, width = popcount(candidate), weight 1:
//     the bit-plane product Cb·Tbᵀ of the matmul form, taken over the bits
//     themselves, and popc(c & t) of the subset test are one number;
//   src/repro/kernels/vertical_count.py:_vertical_matmul_kernel
//     (kVertical) a = 0/1 item membership of each candidate, width = its
//     distinct real items, b = each transaction's item planes, weight = its
//     valid bit;
//   src/repro/kernels/delta_count.py:_delta_count_matmul_kernel
//     (kBits, kWeighted) the same products, weight = the slab row's int32
//     sign (any int32 is taken), staged beside the row's words.
//
//   count[m] = Σ_n weight[n] · [ Σ_k a[m,k]·b[n,k] == width[m] ]   (n < N)
//
// exact int32 (sums wrap as the reference's int32 sums do), equal to the
// plain versions bit for bit.
//
// kBits runs wgmma .b1 (BGMMA.64x128x256.AND.POPC), which reads the same
// 32 bytes of K a row as the int8 k32 step but takes them as 256 bits: the
// packed words go into the tiles as they are, with no expansion, and a
// transaction of up to 256 items is one k-step.  It issues at the int8
// instruction's rate, 8× its ops (PERF.md's probe); what bounds it is the
// compare epilogue below.  Its chunks are one k-step (kKCBits), so a
// staged chunk of a tile is one fetch.
//
// Bound on the H100 SXM (700 W), at the c20d200k phase (M = 40,960,
// N = 200,000, 192 items): kBits' 2·M·N·K bit operations (K = 32W = 192
// bits) at 8 × 1,979 TOP/s, 0.20 ms; kVertical's int8 product, 2·M·N·K
// at 1,979 TOP/s, 1.59 ms — beside which the packed inputs are a few MB.
// The compare epilogue is a second bound on the CUDA cores: M·N compares
// and adds, about 1 ms there, and it is what bounds kBits.
//
// How the design meets the three things that held the __dp4a kernel back:
//
// 1. Tensor cores.  wgmma.mma_async m64n128k32 .s32.s8.s8 (kVertical; the
//    m64n128k256 .b1 step of kBits reads the same layout), both operands
//    K-major in shared memory, no swizzle: a tile of R rows keeps its 16-byte
//    row pieces column by column, offset(r, k) = (k/16)·16R + 16r + k%16, so
//    a core matrix (8 rows × 16 bytes) is 128 contiguous bytes, the leading
//    byte offset (next 16 bytes of K) is 16R and the stride byte offset (next
//    8 rows) 128.  A block of four warpgroups holds kBM = 256 candidates
//    (64 rows a warpgroup) for its whole slice of transactions and walks the
//    slice in tiles of kBN = 128, so each staged transaction tile feeds four
//    m64n128 products.  K up to 256 is one chunk and the candidate tile is
//    built once; wider K is walked in chunks of 128 bytes staged beside the
//    transaction tiles.  K is padded with zero planes to a multiple of 32
//    (zero planes add nothing to an overlap).
// 2. Packed operands in.  kBits stores the (C, W) and (T, W) words into
//    the tiles as they are.  kVertical reads the item-major vertical DB
//    (I+1, Tw) and the (C, kmax) item ids and builds the int8 planes in
//    shared memory, column 32w + b = bit b of word w, four planes of a
//    nibble at a time with ((x & 0xF) * 0x00204081) & 0x01010101.
//    The vertical DB is transposed on the way in: lane k of a warp holds
//    item k's word of 32 transactions, and a five-step shuffle transpose
//    leaves lane j holding transaction j's 32 item bits.  Each block builds
//    its membership rows from its own ids (duplicates collapse, the sentinel
//    drops out) and counts their distinct real items.
// 3. The epilogue in registers.  An overlap never exceeds its row's width,
//    so a match is one add and bit 31 (count_matches).  A warpgroup issues
//    its products of a tile, loads and expands the next stage with the
//    others, meets them at the block's barrier, and only then waits for its
//    own products and counts their matches.  On the H100 the compares and
//    the expansion still add to the products' time rather than hide under
//    it (PERF.md).  A three-stage ring keeps the stage being written apart
//    from those still being read.  The weight costs no compare: an invalid
//    or ragged transaction (n ≥ N) gets zero planes, which match no
//    candidate of width ≥ 1; empty candidates (width 0) are left out of the
//    compare and take the slice's count of valid transactions at the end,
//    and rows m ≥ M are never compared.  Four lanes share a row and meet by
//    shuffles; one int32 atomicAdd per candidate and block merges the
//    slices across gridDim.y — exact in any order.
// 4. A signed row weight (kWeighted, the delta counts).  The 128 weights of
//    a transaction tile are staged in the ring beside its words (0 for
//    n ≥ N), and a match adds weight[col] of its accumulator's column, read
//    from shared memory as an int2 a column pair — no weight registers
//    beside the 64 accumulators.  A tile whose weights are all equal (a
//    streaming slab is +1 rows then −1 rows, so every 128-row tile of it
//    is) counts its matches as the unweighted mode does and multiplies
//    once; a flag a warp, set where the tile is staged, picks that path for
//    the whole block.  Empty candidates take the sum of the slice's
//    weights.  The mining instances (kWeighted = false) compile none of it.
//
// Launch: the SM count is read once a process, and an instance's dynamic
// shared-memory limit is raised only when a launch needs more than before
// (once, for launches of one K), not on every launch.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "common.cuh"

namespace {

constexpr int kMmaThreads = 512;            // four warpgroups
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kBM = 256;                    // candidates a block
constexpr int kBN = 128;                    // transactions a tile (wgmma N)
constexpr int kKC = 256;                    // most K bytes held in one chunk
constexpr int kKCWide = 128;                // chunk bytes past that
constexpr int kStages = 3;                  // ring of transaction tiles
constexpr int kAcc = 64;                    // s32 accumulators a thread

// What a tile's K bytes hold (the block's kMode):
constexpr int kVertical = 1;  // int8 planes: membership rows × vertical DB
constexpr int kBits = 2;      // the (C, W) and (T, W) words themselves, b1
constexpr int kKCBits = 32;   // K bytes of a chunk of bits: 256 bits, 8 words

struct OverlapMmaArgs {
  const uint32_t* a;     // support, delta: (C, W) candidate words
  const int32_t* idx;    // vertical: (C, kmax) item ids, padded with n_items
  const uint32_t* b;     // support: (T, W) transaction words; vertical:
                         // the (n_items + 1, tw) DB, row n_items = valid
  const int32_t* weight; // kWeighted: (N,) row weights, nullptr = all 1
  int32_t* out;          // (C,)
  int n_cands, n_rows;   // M, and N (T, or 32·tw for the vertical DB)
  int n_words;           // support: W
  int kmax, n_items, tw; // vertical
  int k_pad;             // K rounded up to a multiple of 32, at least 32
  int kc, n_chunks;      // K bytes a chunk, and chunks: ceil(k_pad / kc)
  int rows_per_split;    // transactions a block (a multiple of kBN)
};

// four 0/1 bytes from the low nibble of x: byte b = bit b
__device__ __forceinline__ uint32_t nibble_planes(uint32_t x) {
  return ((x & 0xFu) * 0x00204081u) & 0x01010101u;
}

// word x as row r, K bytes 4w..4w+3 (bits 32w..32w+31), of a tile of
// `rows` rows laid out as offset(r, k) = (k/16)·16·rows + 16r + k%16
__device__ __forceinline__ void store_word(uint8_t* tile, int rows, int r,
                                           int w, uint32_t x) {
  *reinterpret_cast<uint32_t*>(tile + (size_t)(w >> 2) * rows * 16 + r * 16 +
                               (w & 3) * 4) = x;
}

// the 32 planes of word x as row r, K bytes 32w..32w+31, of the same layout
__device__ __forceinline__ void store_planes(uint8_t* tile, int rows, int r,
                                             int w, uint32_t x) {
  uint8_t* p = tile + (size_t)(2 * w) * rows * 16 + r * 16;
  *reinterpret_cast<uint4*>(p) =
      make_uint4(nibble_planes(x), nibble_planes(x >> 4),
                 nibble_planes(x >> 8), nibble_planes(x >> 12));
  *reinterpret_cast<uint4*>(p + rows * 16) =
      make_uint4(nibble_planes(x >> 16), nibble_planes(x >> 20),
                 nibble_planes(x >> 24), nibble_planes(x >> 28));
}

// 32×32 bit transpose across a warp: lane i holds row i (bit j = column j)
// before, lane j holds column j (bit i = row i) after — the off-diagonal
// blocks swap at widths 16, 8, 4, 2, 1
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  const uint32_t lo[5] = {0x0000FFFFu, 0x00FF00FFu, 0x0F0F0F0Fu, 0x33333333u,
                          0x55555555u};
#pragma unroll
  for (int t = 0; t < 5; ++t) {
    const int s = 16 >> t;
    const uint32_t y = __shfl_xor_sync(0xffffffffu, x, s);
    x = (lane & s) ? ((x & ~lo[t]) | ((y >> s) & lo[t]))
                   : ((x & lo[t]) | ((y & lo[t]) << s));
  }
  return x;
}

// shared-memory matrix descriptor, no swizzle: start, leading byte offset
// (K direction) and stride byte offset (8-row groups), each in 16 bytes
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma that owns them
__device__ __forceinline__ void fence_acc(int (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// the 64 s32 accumulators of an m64n128 product, as asm operands %0..%63
#define WGMMA_ACC_REGS                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"  \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"  \
  " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"  \
  " %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"  \
  " %58, %59, %60, %61, %62, %63}"
#define WGMMA_ACC_OPERANDS(d)                                              \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),  \
  "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),             \
  "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),         \
  "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),         \
  "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),         \
  "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),         \
  "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),         \
  "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]),         \
  "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]),         \
  "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]),         \
  "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),         \
  "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),         \
  "+r"(d[61]), "+r"(d[62]), "+r"(d[63])

// d (+)= A·Bᵀ for a 64-row A and a 128-row B, each 32 bytes of K a row,
// int32 out; scale_d = 0 starts the sum at zero.  kB1 = false: int8 planes,
// K = 32 (IGMMA.64x128x32.S8.S8); kB1 = true: single bits, K = 256, each
// product the popcount of the AND (BGMMA.64x128x256.AND.POPC).  Both read
// the same tile layout and leave the same accumulator fragment.
template <bool kB1>
__device__ __forceinline__ void wgmma_m64n128(int (&d)[kAcc], uint64_t da,
                                              uint64_t db, int scale_d) {
  if constexpr (kB1)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k256.s32.b1.b1.and.popc "
        WGMMA_ACC_REGS ", %64, %65, p;\n}\n"
        : WGMMA_ACC_OPERANDS(d)
        : "l"(da), "l"(db), "r"(scale_d));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        WGMMA_ACC_REGS ", %64, %65, p;\n}\n"
        : WGMMA_ACC_OPERANDS(d)
        : "l"(da), "l"(db), "r"(scale_d));
}

// KS k-steps in a straight line: a runtime loop splits them into groups
// that the compiler fences one by one
template <bool kB1, int KS>
__device__ __forceinline__ void mma_steps(int (&d)[kAcc], const uint8_t* a,
                                          const uint8_t* b, int wg,
                                          bool first) {
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const uint64_t da = smem_desc(a + wg * 64 * 16 + k * 2 * kBM * 16,
                                  kBM * 16, 128);
    const uint64_t db = smem_desc(b + k * 2 * kBN * 16, kBN * 16, 128);
    wgmma_m64n128<kB1>(d, da, db, (first && k == 0) ? 0 : 1);
  }
}

// One warpgroup's products over ks k-steps of a chunk: its 64 rows of the
// candidate tile a (kBM rows) against the transaction tile b (kBN rows).
// A chunk of bits is always one k-step (kKCBits).
template <bool kB1>
__device__ __forceinline__ void mma_chunk(int (&d)[kAcc], const uint8_t* a,
                                          const uint8_t* b, int wg, int ks,
                                          bool first) {
  if constexpr (kB1) {
    mma_steps<true, 1>(d, a, b, wg, first);
    return;
  }
  switch (ks) {
    case 1: mma_steps<false, 1>(d, a, b, wg, first); break;
    case 2: mma_steps<false, 2>(d, a, b, wg, first); break;
    case 3: mma_steps<false, 3>(d, a, b, wg, first); break;
    case 4: mma_steps<false, 4>(d, a, b, wg, first); break;
    case 5: mma_steps<false, 5>(d, a, b, wg, first); break;
    case 6: mma_steps<false, 6>(d, a, b, wg, first); break;
    case 7: mma_steps<false, 7>(d, a, b, wg, first); break;
    default: mma_steps<false, 8>(d, a, b, wg, first); break;
  }
}

// Add the matches of one tile to hits.  The accumulator of register i sits in
// row 16·(warp % 4) + lane/4 + 8·(bit 1 of i) of the warpgroup's 64 rows; its
// column does not matter here.  An overlap never exceeds its row's width w,
// so it matches where overlap + (2³¹ − w) reaches 2³¹: bit 31 of one add,
// taken into the count by one more (off[r] = 0 for a row never compared).
// Four partial counts keep the adds apart.
__device__ __forceinline__ void count_matches(const int (&d)[kAcc],
                                              const uint32_t (&off)[2],
                                              uint32_t (&hits)[4]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int r = (i >> 1) & 1;
    hits[2 * r + ((i >> 2) & 1)] += ((uint32_t)d[i] + off[r]) >> 31;
  }
}

// The weighted count of one tile: a match adds its column's weight.  w
// holds the tile's 128 weights; accumulator i sits in column
// 8·(i/4) + 2·(lane%4) + (i%2), so col0 = 2·(lane%4) and the column pair of
// accumulators 4j..4j+3 is one int2 read (four distinct ones a warp: no
// bank conflict).  Sums wrap in uint32, as int32 sums do.
__device__ __forceinline__ void count_weighted(const int (&d)[kAcc],
                                               const uint32_t (&off)[2],
                                               const int32_t* w, int col0,
                                               uint32_t (&hits)[4]) {
#pragma unroll
  for (int j = 0; j < kAcc / 4; ++j) {
    const int2 wc = *reinterpret_cast<const int2*>(w + 8 * j + col0);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * j + k, r = (i >> 1) & 1;
      hits[2 * r + (j & 1)] += (((uint32_t)d[i] + off[r]) >> 31) *
                               (uint32_t)(k & 1 ? wc.y : wc.x);
    }
  }
}

// A weighted stage: kBN weights, then one byte a warp of warps 0..3 (1 =
// its 32 weights are equal), padded so that every stage is 16-byte aligned
constexpr int kWStride = kBN + 4;

// The weighted count of a tile whose weights the stage w holds: one
// multiply when they are all equal (the flags of warps 0..3 and the first
// weight of each agree; the same answer for every thread, so the block
// takes one path), else a weight a match
__device__ __forceinline__ void count_tile_weighted(const int (&d)[kAcc],
                                                    const uint32_t (&off)[2],
                                                    const int32_t* w, int col0,
                                                    uint32_t (&hits)[4]) {
  const int32_t u = w[0];
  if (*reinterpret_cast<const uint32_t*>(w + kBN) == 0x01010101u &&
      w[32] == u && w[64] == u && w[96] == u) {
    uint32_t t[4] = {0u, 0u, 0u, 0u};
    count_matches(d, off, t);
#pragma unroll
    for (int j = 0; j < 4; ++j) hits[j] += (uint32_t)u * t[j];
  } else {
    count_weighted(d, off, w, col0, hits);
  }
}

template <int kMode, bool kWeighted = false>
struct OverlapMmaBlock {
  static_assert(kMode == kVertical || kMode == kBits, "no such mode");
  static_assert(!kWeighted || kMode == kBits, "weights ride the bits mode");

  const OverlapMmaArgs& p;
  uint8_t* smem;
  int tid, lane, warp, wg, m0, n_begin, n_end, iters;
  int32_t* wring;        // kWeighted: kStages stages of kWStride ints

  __device__ uint8_t* stage_a(int s) const {
    return p.n_chunks == 1 ? smem : smem + (size_t)s * (kBM + kBN) * p.kc;
  }
  __device__ uint8_t* stage_b(int s) const {
    return p.n_chunks == 1
               ? smem + (size_t)(kBM + s * kBN) * p.kc
               : smem + (size_t)(s * (kBM + kBN) + kBM) * p.kc;
  }
  __device__ int chunk_bytes(int c) const {
    return min(p.kc, p.k_pad - c * p.kc);
  }

  // candidate planes of K bytes [k0, k0 + kc)
  __device__ void build_a(uint8_t* tile, int k0, int kc) const {
    if constexpr (kMode == kVertical) {
      // a thread owns a row: zero it, then set its items' planes
      if (tid < kBM) {
        const int m = m0 + tid;
        uint8_t* row = tile + tid * 16;
        for (int c16 = 0; c16 < kc / 16; ++c16)
          *reinterpret_cast<uint4*>(row + c16 * kBM * 16) =
              make_uint4(0u, 0u, 0u, 0u);
        if (m < p.n_cands) {
          for (int j = 0; j < p.kmax; ++j) {
            const int k = __ldg(p.idx + (size_t)m * p.kmax + j) - k0;
            if (k >= 0 && k < kc && k0 + k < p.n_items)
              row[(k >> 4) * kBM * 16 + (k & 15)] = 1;
          }
        }
      }
    } else {
      const int w0 = k0 / 4, nw = kc / 4;   // a word is 4 K bytes
      for (int i = tid; i < kBM * nw; i += kMmaThreads) {
        const int r = i % kBM, w = i / kBM, m = m0 + r;
        const uint32_t x =
            (m < p.n_cands && w0 + w < p.n_words)
                ? __ldg(p.a + (size_t)m * p.n_words + w0 + w) : 0u;
        store_word(tile, kBM, r, w, x);
      }
    }
  }

  // The transaction planes of a tile are staged in two steps, so that the
  // loads of the next tile are in flight while this tile's products are
  // issued: fetch_b loads the packed words a thread needs (at most kFetch),
  // expand_b writes their planes (or, for bits, the words).  Tile rows
  // [n0, n0 + kBN), K bytes [k0, k0 + kc).  Bits take thread i to word
  // i % 8 of row i / 8, so a warp reads four rows' words in one piece.
  static constexpr int kFetch = 2;

  __device__ void fetch_b(uint32_t (&x)[kFetch], int n0, int k0,
                          int kc) const {
    if constexpr (kMode == kVertical) {
      // warp unit u: 32 items (g) × 32 transactions (q); lane = item
      const uint32_t* valid = p.b + (size_t)p.n_items * p.tw;
#pragma unroll
      for (int j = 0; j < kFetch; ++j) {
        const int u = warp + j * kMmaWarps, g = u / (kBN / 32);
        const int wd = (n0 >> 5) + u % (kBN / 32), item = k0 + 32 * g + lane;
        x[j] = (g < kc / 32 && wd < (n_end >> 5) && item < p.n_items)
                   ? __ldg(p.b + (size_t)item * p.tw + wd) & __ldg(valid + wd)
                   : 0u;
      }
    } else {
      static_assert(kFetch * kMmaThreads == kBN * kKCBits / 4,
                    "one fetch stages a whole chunk of bits");
#pragma unroll
      for (int j = 0; j < kFetch; ++j) {
        const int i = tid + j * kMmaThreads, r = i / 8, w = i % 8;
        const int n = n0 + r, word = k0 / 4 + w;
        x[j] = (n < n_end && word < p.n_words)
                   ? __ldg(p.b + (size_t)n * p.n_words + word) : 0u;
      }
    }
  }

  __device__ void expand_b(uint8_t* tile, const uint32_t (&x)[kFetch],
                           int kc) const {
#pragma unroll
    for (int j = 0; j < kFetch; ++j) {
      if constexpr (kMode == kBits) {
        const int i = tid + j * kMmaThreads;
        store_word(tile, kBN, i / 8, i % 8, x[j]);
      } else {
        const int u = warp + j * kMmaWarps;
        if (u < (kc / 32) * (kBN / 32))      // the same for the whole warp
          store_planes(tile, kBN, 32 * (u % (kBN / 32)) + lane,
                       u / (kBN / 32), transpose32(x[j], lane));
      }
    }
  }

  // iteration it: tile it / n_chunks, chunk it % n_chunks
  __device__ int tile_row(int it) const {
    return n_begin + (it / p.n_chunks) * kBN;
  }

  // kWeighted: the weight of row tid of iteration it's tile (threads
  // 0..kBN-1), 0 past the slice
  __device__ int32_t fetch_weight(int it) const {
    const int n = tile_row(it) + tid;
    if (tid >= kBN || n >= n_end) return 0;
    return p.weight ? __ldg(p.weight + n) : 1;
  }
  // stage it: the weights, and each of warps 0..3 flags whether its 32 are
  // equal
  __device__ void stage_weight(int it, int32_t wt) const {
    if (tid >= kBN) return;
    int32_t* w = wring + (it % kStages) * kWStride;
    w[tid] = wt;
    const bool same =
        __all_sync(0xffffffffu, wt == __shfl_sync(0xffffffffu, wt, 0));
    if (lane == 0) reinterpret_cast<uint8_t*>(w + kBN)[warp] = same;
  }

  // stage the planes of iteration it whose words x were fetched
  __device__ void produce(int it, const uint32_t (&x)[kFetch]) const {
    const int s = it % kStages, c = it % p.n_chunks;
    if (p.n_chunks > 1) build_a(stage_a(s), c * p.kc, chunk_bytes(c));
    expand_b(stage_b(s), x, chunk_bytes(c));
  }
  __device__ void fetch(uint32_t (&x)[kFetch], int it) const {
    fetch_b(x, tile_row(it), (it % p.n_chunks) * p.kc,
            chunk_bytes(it % p.n_chunks));
  }
};

// shared-memory bytes of the ring: one chunk keeps the candidate tile
// resident beside kStages transaction tiles, more chunks stage both
__host__ __device__ constexpr size_t ring_bytes(int n_chunks, int kc) {
  return n_chunks == 1 ? (size_t)(kBM + kStages * kBN) * kc
                       : (size_t)kStages * (kBM + kBN) * kc;
}

template <int kMode, bool kWeighted = false>
__global__ void __launch_bounds__(kMmaThreads, 1)
overlap_mma_kernel(const __grid_constant__ OverlapMmaArgs p) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int s_width[kBM];   // −1 for rows m ≥ M
  __shared__ int s_valid;        // valid transactions (kWeighted: the sum
                                 // of the weights) of this slice

  OverlapMmaBlock<kMode, kWeighted> blk{p, smem};
  blk.tid = threadIdx.x;
  blk.lane = blk.tid & 31;
  blk.warp = blk.tid >> 5;
  blk.wg = blk.warp >> 2;
  blk.m0 = blockIdx.x * kBM;
  blk.n_begin = blockIdx.y * p.rows_per_split;
  blk.n_end = min(p.n_rows, blk.n_begin + p.rows_per_split);
  const int n_tiles =
      blk.n_end > blk.n_begin ? (blk.n_end - blk.n_begin + kBN - 1) / kBN : 0;
  blk.iters = n_tiles * p.n_chunks;

  if (blk.tid < kBM) {
    const int m = blk.m0 + blk.tid;
    int width = -1;
    if (m < p.n_cands) {
      width = 0;
      if constexpr (kMode == kVertical) {   // distinct real items
        const int32_t* ids = p.idx + (size_t)m * p.kmax;
        for (int j = 0; j < p.kmax; ++j) {
          const int id = __ldg(ids + j);
          bool seen = id >= p.n_items;
          for (int i = 0; i < j; ++i) seen = seen || __ldg(ids + i) == id;
          width += !seen;
        }
      } else {
        for (int w = 0; w < p.n_words; ++w)
          width += __popc(__ldg(p.a + (size_t)m * p.n_words + w));
      }
    }
    s_width[blk.tid] = width;
  }
  if constexpr (kWeighted)
    blk.wring = reinterpret_cast<int32_t*>(smem + ring_bytes(p.n_chunks, p.kc));
  if (blk.warp == kMmaWarps - 1) {
    int v = max(blk.n_end - blk.n_begin, 0);
    if constexpr (kWeighted) {
      uint32_t sum = 0;
      for (int n = blk.n_begin + blk.lane; n < blk.n_end; n += 32)
        sum += p.weight ? (uint32_t)__ldg(p.weight + n) : 1u;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      v = (int)sum;
    }
    if constexpr (kMode == kVertical) {
      const uint32_t* valid = p.b + (size_t)p.n_items * p.tw;
      v = 0;
      for (int wd = (blk.n_begin >> 5) + blk.lane; wd < (blk.n_end >> 5);
           wd += 32)
        v += __popc(__ldg(valid + wd));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    }
    if (blk.lane == 0) s_valid = v;
  }
  if (p.n_chunks == 1) blk.build_a(blk.stage_a(0), 0, p.kc);
  uint32_t words[OverlapMmaBlock<kMode, kWeighted>::kFetch];
  int32_t wt = 0;                // kWeighted: the next tile's row weight
  if (blk.iters > 0) {
    blk.fetch(words, 0);
    if constexpr (kWeighted) wt = blk.fetch_weight(0);
    blk.produce(0, words);
    if constexpr (kWeighted) blk.stage_weight(0, wt);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int rows[2] = {blk.wg * 64 + (blk.warp & 3) * 16 + (blk.lane >> 2),
                       blk.wg * 64 + (blk.warp & 3) * 16 + (blk.lane >> 2) + 8};
  uint32_t off[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int w = s_width[rows[j]];
    off[j] = w > 0 ? 0x80000000u - (uint32_t)w : 0u;
  }
  uint32_t hits[4] = {0u, 0u, 0u, 0u};
  const int col0 = 2 * (blk.lane & 3);
  int acc[kAcc];
  // Each warpgroup issues its products on stage it % 3 (the next stage's
  // words already loading), helps expand the next stage, meets the others
  // at the barrier (the next stage is then complete), and only then waits
  // for its own products and counts them.  The stage that iteration it + 1
  // writes was last read by iteration it − 2, whose products every
  // warpgroup waited for before the barrier of iteration it − 1.
  for (int it = 0; it < blk.iters; ++it) {
    const int c = it % p.n_chunks, s = it % kStages;
    const bool next = it + 1 < blk.iters;
    if (next) blk.fetch(words, it + 1);
    if constexpr (kWeighted) if (next) wt = blk.fetch_weight(it + 1);
    fence_acc(acc);
    wgmma_fence();
    mma_chunk<kMode == kBits>(acc, blk.stage_a(s), blk.stage_b(s), blk.wg,
              blk.chunk_bytes(c) / 32, c == 0);
    wgmma_commit();
    if (next) blk.produce(it + 1, words);
    if constexpr (kWeighted) if (next) blk.stage_weight(it + 1, wt);
    // the staged planes, written by the generic proxy, become visible to the
    // tensor cores' async proxy, and the stage is complete
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    wgmma_wait<0>();
    fence_acc(acc);
    if constexpr (kWeighted) {
      if (c == p.n_chunks - 1)
        count_tile_weighted(acc, off, blk.wring + s * kWStride, col0, hits);
    } else {
      if (c == p.n_chunks - 1) count_matches(acc, off, hits);
    }
  }

  // four lanes share each row
  int h[2] = {(int)(hits[0] + hits[1]), (int)(hits[2] + hits[3])};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    h[j] += __shfl_xor_sync(0xffffffffu, h[j], 1);
    h[j] += __shfl_xor_sync(0xffffffffu, h[j], 2);
  }
  if ((blk.lane & 3) == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = blk.m0 + rows[j];
      const int v = h[j] + (s_width[rows[j]] == 0 ? s_valid : 0);
      if (m < p.n_cands && v) atomicAdd(p.out + m, v);
    }
  }
}

// Slices of the transaction axis for bx candidate blocks.  One block fills
// an SM, so the grid runs in waves of n_sms blocks and a ragged last wave
// leaves SMs idle: take whole tiles, at least two waves, and the slice
// count whose waves cost least (a block's set-up costs about kSetupRows
// rows of work).
constexpr int kSetupRows = 2 * kBN;

inline void split_rows(int n_rows, int bx, int n_sms, int* splits,
                       int* per) {
  const int tiles = n_rows > kBN ? ceil_div(n_rows, kBN) : 1;
  int lo = ceil_div(2 * n_sms, bx);
  lo = lo < 1 ? 1 : (lo > tiles ? tiles : lo);
  int best_s = lo;
  long long best = -1;
  for (int s = lo; s <= 8 * lo && s <= tiles && s <= 65535; ++s) {
    const int t_per = ceil_div(tiles, s);        // tiles a block
    const int used = ceil_div(tiles, t_per);     // slices that hold rows
    const long long cost =
        (long long)ceil_div((long long)bx * used, n_sms) *
        ((long long)t_per * kBN + kSetupRows);
    if (best < 0 || cost < best) {
      best = cost;
      best_s = s;
    }
  }
  const int t_per = ceil_div(tiles, best_s);
  *per = t_per * kBN;
  *splits = ceil_div(tiles, t_per);
}

// The SM count, read once a process (of the card current at the first
// launch: the port drives one card a process); a static local is
// initialised once, thread-safely.  0 if it cannot be read.
inline int sm_count() {
  static const int n_sms = [] {
    int dev, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    return n;
  }();
  return n_sms;
}

// Raise an instance's dynamic shared-memory limit to smem bytes where no
// launch has needed as much before: once, for launches of one K
template <int kMode, bool kWeighted>
cudaError_t raise_smem_limit(size_t smem) {
  static std::mutex mu;
  static size_t raised = 0;
  std::lock_guard<std::mutex> lock(mu);
  if (smem <= raised) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      overlap_mma_kernel<kMode, kWeighted>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) raised = smem;
  return err;
}

// Zero the output, size the ring for k bytes of K a row, split the
// transactions across gridDim.y and launch.
template <int kMode, bool kWeighted = false>
cudaError_t launch_overlap_mma(OverlapMmaArgs p, int k, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(p.out, 0,
                                    (size_t)p.n_cands * sizeof(int32_t),
                                    stream);
  if (err != cudaSuccess || p.n_cands == 0) return err;
  const int n_sms = sm_count();
  if (n_sms == 0) return cudaErrorNoDevice;
  p.k_pad = k > 32 ? (k + 31) / 32 * 32 : 32;
  // one chunk keeps the candidate planes resident; wider K streams them
  // beside the transactions' in narrower chunks, so three stages still fit.
  // Bits come in chunks of one k-step, the most one fetch stages.
  p.kc = kMode == kBits ? kKCBits : p.k_pad <= kKC ? p.k_pad : kKCWide;
  p.n_chunks = ceil_div(p.k_pad, p.kc);
  const size_t smem =
      ring_bytes(p.n_chunks, p.kc) +
      (kWeighted ? kStages * kWStride * sizeof(int32_t) : 0);
  if ((err = raise_smem_limit<kMode, kWeighted>(smem)) != cudaSuccess)
    return err;
  const int bx = ceil_div(p.n_cands, kBM);
  int splits;
  split_rows(p.n_rows, bx, n_sms, &splits, &p.rows_per_split);
  overlap_mma_kernel<kMode, kWeighted>
      <<<dim3(bx, splits), kMmaThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
