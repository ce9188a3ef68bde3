// Hand-written Hopper (sm_90a) kernels for rule serving: the masked
// rule-score matrix of one query dispatch.
//
//     out[q, r] = score[r]  if ante[r] ⊆ basket[q]
//                           (and, with exclude, cons[r] ⊄ basket[q])
//                 -inf      otherwise
//
// for (R, W) antecedent and consequent masks, (R,) float32 scores and
// (Q, W) basket masks, all as 32-bit words.  The top-k that reads the
// matrix is a plain torch op around the kernel (serving/rules_engine.py), as
// lax.top_k sits outside the Pallas kernel in the reference.
//
// Neither TPU kernel accumulates: every output element is written exactly
// once, so the kernels need no atomics and no zeroing.  The reference pads
// rules with -inf scores and baskets with zero rows to its tile sizes
// (rule_match.py:85-95); these kernels take any R and Q and mask the ragged
// edges in their bounds instead.
//
// Bound on the H100: the bytes.  The (Q, R) float32 output dominates — at
// the serving shape Qp = 512 against 43,694 rules it is 89 MB, 27 µs at
// 3.35 TB/s — beside the R·W word tests, which are a few per output.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "common.cuh"
#include "overlap_mma.cuh"

namespace {

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// ---------------------------------------------------------------------------
// rule_scores — replaces rule_match.py:_rule_scores_kernel.
//
// The popcount-AND form on the CUDA cores.  What held its first version
// back, and what this one does about it:
//
// * The test.  ante ⊆ basket iff no word of ante & ~basket is set, so each
//   side's violations accumulate as viol |= a & ~b, one LOP3 a word, query
//   and side, and each output takes one compare a side and a select (not
//   (a & b) != a and a conditional bit clear, three a word).
// * The tiling.  A block of kScThreads threads owns kScR = 512 rules against
//   kScQ = 64 queries: a thread keeps four rules' antecedent and consequent
//   words, and their scores, in registers for the whole tile, and each
//   query's basket words are one broadcast read from shared memory.  The
//   arena is read once a query tile, Q/64 times in all (32 times before).
// * The stores.  The output's row pitch, R·4 bytes, is only 4- or 8-byte
//   aligned.  The store probe (python -m repro_torch.probes.store_floor,
//   PERF.md) found 4-byte stores from registers, a thread a column, at
//   1.6–1.75× the bytes' bound however long the row piece of a block (each
//   warp store straddles sectors in three rows of four), and a warp writing
//   a 2 KB row piece from its first 16-byte boundary at 1.4× (as TMA bulk
//   stores).  So the scores of kScPass queries go into a staged tile in
//   shared memory, each row shifted so that its first 16-byte boundary in
//   the output is 16-byte aligned there, and each warp then writes whole
//   rows: a masked scalar head, float4 stores, a masked scalar tail.  A
//   store does not wait: a pass's stores drain while the next pass tests,
//   and blocks of other tiles fill the SM.
//
// W ≤ 8 words keeps a rule's words in registers (one instance a W); wider
// rules (more than 256 items) take rule_scores_wide_kernel, which walks the
// words kScChunk at a time and keeps one bit a query for each side.
//
// Bound on the H100: the bytes, the (Q, R) float32 output (89 MB at the
// serving shape, 27 µs at 3.35 TB/s), against which the tests (2W LOP3s,
// two compares and a select an output, about 17 µs of the integer pipes
// at W = 4) should hide.
//
// Triton would serve this elementwise pass as well; CUDA keeps the single
// build route of kernels/_build.py (nvcc into a library with a C interface),
// and the CPU test machine has no Triton to check it with.
// ---------------------------------------------------------------------------

constexpr int kScThreads = 128;                 // threads a block
constexpr int kScRules = 4;                     // rules a thread, 128 apart
constexpr int kScR = kScThreads * kScRules;     // rules a block: 2 KB a row
constexpr int kScQ = 64;                        // queries a block
constexpr int kScChunk = 4;                     // words a pass past 8 words

constexpr int kScPass = 16;                     // queries a staged pass
constexpr int kScPitch = kScR + 4;              // floats a staged row
static_assert(kScQ % kScPass == 0 && kScPass % (kScThreads / 32) == 0,
              "passes tile the queries, warps the rows of a pass");

// words a staged basket takes: W, padded to whole uint4 from 3 words up
template <int W>
__host__ __device__ constexpr int basket_pitch() {
  return W <= 2 ? W : (W + 3) / 4 * 4;
}

// the W words of a staged basket, in vector reads
template <int W>
__device__ __forceinline__ void read_basket(const uint32_t* p,
                                            uint32_t (&b)[W]) {
  constexpr int kP = basket_pitch<W>();
  uint32_t t[kP];
  if constexpr (kP % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kP; i += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + i);
      t[i] = v.x;
      t[i + 1] = v.y;
      t[i + 2] = v.z;
      t[i + 3] = v.w;
    }
  } else if constexpr (kP == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    t[0] = v.x;
    t[1] = v.y;
  } else {
    t[0] = p[0];
  }
#pragma unroll
  for (int w = 0; w < W; ++w) b[w] = t[w];
}

// Stage the words [w0, w0 + nw) of the block's baskets, nw ≤ KP, at KP words
// a basket (zero past the last query and past nw)
template <int KP>
__device__ __forceinline__ void stage_baskets(uint32_t* s_b,
                                              const uint32_t* baskets,
                                              int n_words, int q0, int nq,
                                              int w0, int nw) {
  for (int i = threadIdx.x; i < kScQ * KP; i += kScThreads) {
    const int q = i / KP, w = i % KP;
    s_b[i] = q < nq && w < nw
                 ? __ldg(baskets + (size_t)(q0 + q) * n_words + w0 + w) : 0u;
  }
}

// words [w0, w0 + nw) of rule r into t (zero past nw and for r ≥ R)
template <int KW>
__device__ __forceinline__ void load_rule(uint32_t (&t)[KW],
                                          const uint32_t* words, int r,
                                          int n_rules, int n_words, int w0,
                                          int nw) {
#pragma unroll
  for (int w = 0; w < KW; ++w)
    t[w] = r < n_rules && w < nw
               ? __ldg(words + (size_t)r * n_words + w0 + w) : 0u;
}

// Where row q of the block's tile starts in the staged rows: floats past a
// 16-byte boundary of the output, so that the row's first 16-byte boundary
// falls on one in shared memory (kScPitch is a multiple of 4).  m0 is row
// 0's, and each row moves on by R floats.
__device__ __forceinline__ int row_shift(int m0, int q, int n_rules) {
  return (m0 + q * (n_rules & 3)) & 3;
}

// Write rows [p0, p0 + kScPass) of the block's tile (those below nq) from
// the staged rows: warp w takes rows w, w + 4, ...; columns [0, n) of each,
// a masked scalar head up to the row's first 16-byte boundary, float4
// stores from there, a masked scalar tail.
__device__ __forceinline__ void flush_pass(const float* s_out, float* out,
                                           int n_rules, int q0, int p0,
                                           int nq, int c0, int n, int m0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < kScPass && p0 + i < nq; i += kScThreads / 32) {
    const int q = p0 + i, m = row_shift(m0, q, n_rules);
    const float* src = s_out + i * kScPitch + m;
    float* dst = out + (size_t)(q0 + q) * n_rules + c0;
    const int head = min(n, (4 - m) & 3);
    const int nv = (n - head) >> 2, tail = n - head - 4 * nv;
    if (lane < head) dst[lane] = src[lane];
    const float4* s4 = reinterpret_cast<const float4*>(src + head);
    float4* d4 = reinterpret_cast<float4*>(dst + head);
    for (int v = lane; v < nv; v += 32) d4[v] = s4[v];
    if (lane < tail) dst[head + 4 * nv + lane] = src[head + 4 * nv + lane];
  }
}

template <int W, bool kExclude>
__global__ void __launch_bounds__(kScThreads)
rule_scores_kernel(const uint32_t* __restrict__ ante,
                   const uint32_t* __restrict__ cons,
                   const float* __restrict__ score, int n_rules,
                   const uint32_t* __restrict__ baskets, int n_queries,
                   float* __restrict__ out) {
  constexpr int kP = basket_pitch<W>();
  __shared__ __align__(16) uint32_t s_b[kScQ * kP];
  __shared__ __align__(16) float s_out[kScPass * kScPitch];
  const int c0 = blockIdx.x * kScR, r0 = c0 + threadIdx.x;
  const int q0 = blockIdx.y * kScQ, nq = min(kScQ, n_queries - q0);
  const int n = min(kScR, n_rules - c0);
  const int m0 = (int)((reinterpret_cast<uintptr_t>(
                            out + (size_t)q0 * n_rules + c0) >> 2) & 3);
  stage_baskets<kP>(s_b, baskets, W, q0, nq, 0, W);
  uint32_t a[kScRules][W], c[kScRules][W];
  float s[kScRules];
#pragma unroll
  for (int j = 0; j < kScRules; ++j) {
    const int r = r0 + j * kScThreads;
    load_rule<W>(a[j], ante, r, n_rules, W, 0, W);
    if constexpr (kExclude) load_rule<W>(c[j], cons, r, n_rules, W, 0, W);
    s[j] = r < n_rules ? __ldg(score + r) : 0.f;
  }
  __syncthreads();
  for (int p0 = 0; p0 < nq; p0 += kScPass) {
#pragma unroll 4
    for (int i = 0; i < kScPass; ++i) {
      uint32_t b[W];
      read_basket<W>(s_b + (p0 + i) * kP, b);
      float* row = s_out + i * kScPitch + row_shift(m0, p0 + i, n_rules) +
                   threadIdx.x;
#pragma unroll
      for (int j = 0; j < kScRules; ++j) {
        uint32_t va = 0u, vc = 0u;   // violations: bits of a side not in b
#pragma unroll
        for (int w = 0; w < W; ++w) {
          va |= a[j][w] & ~b[w];
          if constexpr (kExclude) vc |= c[j][w] & ~b[w];
        }
        const bool fire = va == 0u && (!kExclude || vc != 0u);
        row[j * kScThreads] = fire ? s[j] : neg_inf();
      }
    }
    __syncthreads();               // the pass is staged
    flush_pass(s_out, out, n_rules, q0, p0, nq, c0, n, m0);
    __syncthreads();               // its rows are read before the next pass
  }
}

// Any W: the words kScChunk at a time (baskets staged, rules in registers),
// one bit a query of the tile for "a word of the side is not in the basket"
template <bool kExclude>
__global__ void __launch_bounds__(kScThreads)
rule_scores_wide_kernel(const uint32_t* __restrict__ ante,
                        const uint32_t* __restrict__ cons,
                        const float* __restrict__ score, int n_rules,
                        const uint32_t* __restrict__ baskets, int n_queries,
                        int n_words, float* __restrict__ out) {
  static_assert(kScQ == 64, "a query's bit in one uint64_t");
  __shared__ __align__(16) uint32_t s_b[kScQ * kScChunk];
  __shared__ __align__(16) float s_out[kScPass * kScPitch];
  const int c0 = blockIdx.x * kScR, r0 = c0 + threadIdx.x;
  const int q0 = blockIdx.y * kScQ, nq = min(kScQ, n_queries - q0);
  const int n = min(kScR, n_rules - c0);
  const int m0 = (int)((reinterpret_cast<uintptr_t>(
                            out + (size_t)q0 * n_rules + c0) >> 2) & 3);
  uint64_t bad_a[kScRules] = {}, bad_c[kScRules] = {};
  for (int w0 = 0; w0 < n_words; w0 += kScChunk) {
    const int nw = min(kScChunk, n_words - w0);
    __syncthreads();               // the last chunk's reads are done
    stage_baskets<kScChunk>(s_b, baskets, n_words, q0, nq, w0, nw);
    uint32_t a[kScRules][kScChunk], c[kScRules][kScChunk];
#pragma unroll
    for (int j = 0; j < kScRules; ++j) {
      const int r = r0 + j * kScThreads;
      load_rule<kScChunk>(a[j], ante, r, n_rules, n_words, w0, nw);
      if constexpr (kExclude)
        load_rule<kScChunk>(c[j], cons, r, n_rules, n_words, w0, nw);
    }
    __syncthreads();
    for (int q = 0; q < nq; ++q) {
      uint32_t b[kScChunk];
      read_basket<kScChunk>(s_b + q * kScChunk, b);
#pragma unroll
      for (int j = 0; j < kScRules; ++j) {
        uint32_t va = 0u, vc = 0u;
#pragma unroll
        for (int w = 0; w < kScChunk; ++w) {
          va |= a[j][w] & ~b[w];
          if constexpr (kExclude) vc |= c[j][w] & ~b[w];
        }
        bad_a[j] |= (uint64_t)(va != 0u) << q;
        if constexpr (kExclude) bad_c[j] |= (uint64_t)(vc != 0u) << q;
      }
    }
  }
  float s[kScRules];
#pragma unroll
  for (int j = 0; j < kScRules; ++j) {
    const int r = r0 + j * kScThreads;
    s[j] = r < n_rules ? __ldg(score + r) : 0.f;
  }
  for (int p0 = 0; p0 < nq; p0 += kScPass) {
    for (int i = 0; i < kScPass; ++i) {
      const int q = p0 + i;
      float* row = s_out + i * kScPitch + row_shift(m0, q, n_rules) +
                   threadIdx.x;
#pragma unroll
      for (int j = 0; j < kScRules; ++j) {
        const bool fire = !((bad_a[j] >> q) & 1u) &&
                          (!kExclude || ((bad_c[j] >> q) & 1u));
        row[j * kScThreads] = fire ? s[j] : neg_inf();
      }
    }
    __syncthreads();
    flush_pass(s_out, out, n_rules, q0, p0, nq, c0, n, m0);
    __syncthreads();
  }
}

template <int W>
cudaError_t launch_rule_scores(const uint32_t* a, const uint32_t* c,
                               const float* sc, int n_rules,
                               const uint32_t* b, int n_queries, int n_words,
                               bool exclude, float* o, cudaStream_t s) {
  const dim3 grid(ceil_div(n_rules, kScR), ceil_div(n_queries, kScQ));
  if constexpr (W == 0) {
    if (exclude)
      rule_scores_wide_kernel<true><<<grid, kScThreads, 0, s>>>(
          a, c, sc, n_rules, b, n_queries, n_words, o);
    else
      rule_scores_wide_kernel<false><<<grid, kScThreads, 0, s>>>(
          a, c, sc, n_rules, b, n_queries, n_words, o);
  } else {
    if (exclude)
      rule_scores_kernel<W, true><<<grid, kScThreads, 0, s>>>(
          a, c, sc, n_rules, b, n_queries, o);
    else
      rule_scores_kernel<W, false><<<grid, kScThreads, 0, s>>>(
          a, c, sc, n_rules, b, n_queries, o);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// rule_scores_matmul — replaces rule_match.py:_rule_scores_matmul_kernel.
//
// The same matrix from overlaps: ante[r] ⊆ basket[q] iff
// popc(basket[q] & ante[r]) == popc(ante[r]), and cons[r] ⊄ basket[q] iff
// the consequent's overlap differs from its popcount.  The overlaps come
// from the single-bit tensor cores (wgmma .b1 AND-popcount, BGMMA), which
// take the packed words themselves: no planes are unpacked, by the wrapper
// or here.
//
// A block of one warpgroup takes kRsQ = 64 queries (the wgmma M side)
// against kRsR = 128 rules (N).  For each K chunk of kRsWords words it
// copies the basket words and one rule matrix's words into no-swizzle
// K-major tiles (overlap_mma.cuh's layout; K padded with zero words, which
// add nothing to an overlap, ragged rows zero too) and issues one
// m64n128k256 product a 256 bits.  With exclude, the consequent product
// runs first and leaves one bit per accumulator (cons ⊆ basket); the
// antecedent product then reuses the same 64 registers.  The block counts
// its rules' popcounts itself with __popc.
//
// The output bytes are the whole cost (89 MB at the serving shape against
// a 27 µs bound), so the epilogue is built for the stores: each thread
// writes its selected scores into a staged (64, 128) tile in shared memory
// (over the K tiles, whose reads are done), and each warp then writes its
// own 16 query rows back with neighbouring lanes on neighbouring floats,
// 128 contiguous bytes a store.  A row's pitch is R·4 bytes, only 4-byte
// aligned for odd R, so the stores are float-wide and the ragged rule and
// query edges are masked: a half-empty query tile writes no byte past Q.
// ---------------------------------------------------------------------------

constexpr int kRsThreads = 128;          // one warpgroup
constexpr int kRsQ = 64;                 // queries a block (wgmma M)
constexpr int kRsR = 128;                // rules a block (wgmma N)
constexpr int kRsWords = 16;             // words of a K chunk: two k-steps
constexpr int kRsPitch = kRsR + 8;       // floats a row of the staged output
constexpr int kRsSmem = kRsQ * kRsPitch * 4;
static_assert((kRsQ + kRsR) * kRsWords * 4 <= kRsSmem,
              "the K tiles fit under the staged output");

// acc += the overlap of each of the block's baskets (rows of the M tile)
// with each of its rules (words of `rules`, rows of the N tile), over all
// n_words words in chunks of kRsWords
__device__ __forceinline__ void rule_overlaps(
    int (&acc)[kAcc], const uint32_t* __restrict__ rules, int n_rules, int r0,
    const uint32_t* __restrict__ baskets, int n_queries, int q0, int n_words,
    uint8_t* s_q, uint8_t* s_r) {
  const int tid = threadIdx.x;
  for (int w0 = 0; w0 < n_words; w0 += kRsWords) {
    const int nw = min(kRsWords, n_words - w0);
    const int kw = (nw + 7) / 8 * 8;     // words a row, padded to k-steps
    __syncthreads();                     // the tiles' last readers are done
    for (int i = tid; i < kRsQ * kw; i += kRsThreads) {
      const int row = i / kw, w = i % kw, q = q0 + row;
      store_word(s_q, kRsQ, row, w,
                 q < n_queries && w < nw
                     ? __ldg(baskets + (size_t)q * n_words + w0 + w) : 0u);
    }
    for (int i = tid; i < kRsR * kw; i += kRsThreads) {
      const int row = i / kw, w = i % kw, r = r0 + row;
      store_word(s_r, kRsR, row, w,
                 r < n_rules && w < nw
                     ? __ldg(rules + (size_t)r * n_words + w0 + w) : 0u);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    fence_acc(acc);
    wgmma_fence();
    for (int k = 0; k < kw / 8; ++k)
      wgmma_m64n128<true>(acc, smem_desc(s_q + k * 32 * kRsQ, kRsQ * 16, 128),
                          smem_desc(s_r + k * 32 * kRsR, kRsR * 16, 128), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
  }
}

template <bool kExclude>
__global__ void __launch_bounds__(kRsThreads)
rule_scores_matmul_kernel(const uint32_t* __restrict__ ante,
                          const uint32_t* __restrict__ cons,
                          const float* __restrict__ score, int n_rules,
                          const uint32_t* __restrict__ baskets, int n_queries,
                          int n_words, float* __restrict__ out) {
  __shared__ __align__(128) uint8_t smem[kRsSmem];
  __shared__ int s_aw[kRsR], s_cw[kRsR];
  __shared__ float s_score[kRsR];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * kRsR, q0 = blockIdx.y * kRsQ;
  {
    const int r = r0 + tid;              // a thread a rule: its popcounts
    int aw = 0, cw = 0;
    if (r < n_rules) {
      for (int w = 0; w < n_words; ++w) {
        aw += __popc(__ldg(ante + (size_t)r * n_words + w));
        if (kExclude) cw += __popc(__ldg(cons + (size_t)r * n_words + w));
      }
    }
    s_aw[tid] = aw;
    s_cw[tid] = cw;
    s_score[tid] = r < n_rules ? __ldg(score + r) : 0.f;
  }
  uint8_t* s_q = smem;
  uint8_t* s_r = smem + kRsQ * kRsWords * 4;
  // accumulator i: query row 16·warp + lane/4 + 8·(bit 1 of i), rule column
  // 8·(i/4) + 2·(lane%4) + (i%2)
  const int row0 = 16 * warp + (lane >> 2), col0 = 2 * (lane & 3);
  int acc[kAcc];
  uint64_t cons_in = 0;                  // bit i: cons ⊆ basket at acc[i]
  if constexpr (kExclude) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0;
    rule_overlaps(acc, cons, n_rules, r0, baskets, n_queries, q0, n_words,
                  s_q, s_r);
    __syncthreads();                     // s_cw is written
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
      cons_in |= (uint64_t)(acc[i] == s_cw[8 * (i >> 2) + col0 + (i & 1)])
                 << i;
    // the compares happen here, not beside the next product, so the
    // accumulators are free for it (one set of 64 registers, not two)
    asm volatile("" : "+l"(cons_in));
  }
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0;
  rule_overlaps(acc, ante, n_rules, r0, baskets, n_queries, q0, n_words, s_q,
                s_r);
  __syncthreads();         // every product is done: the tiles become output

  float* s_out = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < kAcc; i += 2) {
    const int row = row0 + 8 * ((i >> 1) & 1), col = 8 * (i >> 2) + col0;
    float v[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool fire = acc[i + j] == s_aw[col + j] &&
                        !(kExclude && ((cons_in >> (i + j)) & 1u));
      v[j] = fire ? s_score[col + j] : neg_inf();
    }
    *reinterpret_cast<float2*>(s_out + row * kRsPitch + col) =
        make_float2(v[0], v[1]);
  }
  __syncwarp();                          // a warp reads back its own rows
  const int nr = min(kRsR, n_rules - r0);
  for (int j = 0; j < 16; ++j) {
    const int row = 16 * warp + j, q = q0 + row;
    if (q >= n_queries) break;
    float* dst = out + (size_t)q * n_rules + r0;
    const float* src = s_out + row * kRsPitch;
#pragma unroll
    for (int c = lane; c < kRsR; c += 32)
      if (c < nr) dst[c] = src[c];
  }
}

}  // namespace

extern "C" {

int rule_scores(const void* ante, const void* cons, const void* score,
                int n_rules, const void* baskets, int n_queries, int n_words,
                int exclude, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* a = static_cast<const uint32_t*>(ante);
  const uint32_t* c = static_cast<const uint32_t*>(cons);
  const float* sc = static_cast<const float*>(score);
  const uint32_t* b = static_cast<const uint32_t*>(baskets);
  float* o = static_cast<float*>(out);
  const int R = n_rules, Q = n_queries, W = n_words;
  const bool x = exclude != 0;
  switch (n_words) {
    case 1: return launch_rule_scores<1>(a, c, sc, R, b, Q, W, x, o, s);
    case 2: return launch_rule_scores<2>(a, c, sc, R, b, Q, W, x, o, s);
    case 3: return launch_rule_scores<3>(a, c, sc, R, b, Q, W, x, o, s);
    case 4: return launch_rule_scores<4>(a, c, sc, R, b, Q, W, x, o, s);
    case 5: return launch_rule_scores<5>(a, c, sc, R, b, Q, W, x, o, s);
    case 6: return launch_rule_scores<6>(a, c, sc, R, b, Q, W, x, o, s);
    case 7: return launch_rule_scores<7>(a, c, sc, R, b, Q, W, x, o, s);
    case 8: return launch_rule_scores<8>(a, c, sc, R, b, Q, W, x, o, s);
    default:  // W > 8, and W = 0 (every rule empty)
      return launch_rule_scores<0>(a, c, sc, R, b, Q, W, x, o, s);
  }
}

int rule_scores_matmul(const void* ante, const void* cons, const void* score,
                       int n_rules, const void* baskets, int n_queries,
                       int n_words, int exclude, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(ceil_div(n_rules, kRsR), ceil_div(n_queries, kRsQ));
  const uint32_t* a = static_cast<const uint32_t*>(ante);
  const uint32_t* c = static_cast<const uint32_t*>(cons);
  const float* sc = static_cast<const float*>(score);
  const uint32_t* b = static_cast<const uint32_t*>(baskets);
  float* o = static_cast<float*>(out);
  if (exclude)
    rule_scores_matmul_kernel<true><<<grid, kRsThreads, 0, s>>>(
        a, c, sc, n_rules, b, n_queries, n_words, o);
  else
    rule_scores_matmul_kernel<false><<<grid, kRsThreads, 0, s>>>(
        a, c, sc, n_rules, b, n_queries, n_words, o);
  return cudaGetLastError();
}

}  // extern "C"
