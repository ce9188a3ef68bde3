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
// One thread per output element of a (kQueryTile × kRuleTile) tile: thread x
// indexes rules, so a warp's float32 stores are 128 contiguous bytes of an
// output row; block y indexes a tile of queries.  The block stages the
// antecedent and consequent words of its rules and the words of its baskets
// in shared memory, kWordChunk words at a time, so any W is taken by the
// loop; rule words are stored word-major with one pad column, so the staging
// writes and the per-thread reads fall in distinct banks.  Each thread keeps
// one bit per query of its tile for "ante ⊆ basket" and one for
// "cons ⊆ basket" — the reference's word loop, (a & b) == a — and then
// writes its column of the tile.
//
// Triton would serve this elementwise pass as well; CUDA keeps the single
// build route of kernels/_build.py (nvcc into a library with a C interface),
// and the CPU test machine has no Triton to check it with.
// ---------------------------------------------------------------------------

constexpr int kRuleTile = 128;   // rules per block, one per thread
constexpr int kQueryTile = 16;   // queries per block, one bit each
constexpr int kWordChunk = 8;    // words staged per pass

template <bool kExclude>
__global__ void __launch_bounds__(kRuleTile)
rule_scores_kernel(const uint32_t* __restrict__ ante,
                   const uint32_t* __restrict__ cons,
                   const float* __restrict__ score, int n_rules,
                   const uint32_t* __restrict__ baskets, int n_queries,
                   int n_words, float* __restrict__ out) {
  __shared__ uint32_t s_a[kWordChunk][kRuleTile + 1];
  __shared__ uint32_t s_c[kWordChunk][kRuleTile + 1];
  __shared__ uint32_t s_b[kQueryTile][kWordChunk];
  const int r0 = blockIdx.x * kRuleTile, q0 = blockIdx.y * kQueryTile;
  const int tx = threadIdx.x;
  unsigned ante_in = 0xffffffffu;   // bit q: ante[r] ⊆ basket[q0 + q]
  unsigned cons_in = 0xffffffffu;   // bit q: cons[r] ⊆ basket[q0 + q]
  for (int w0 = 0; w0 < n_words; w0 += kWordChunk) {
    const int nw = min(kWordChunk, n_words - w0);
    for (int i = tx; i < kRuleTile * nw; i += kRuleTile) {
      const int rr = i / nw, ww = i % nw, r = r0 + rr;
      const size_t at = (size_t)r * n_words + w0 + ww;
      s_a[ww][rr] = r < n_rules ? ante[at] : 0u;
      if (kExclude) s_c[ww][rr] = r < n_rules ? cons[at] : 0u;
    }
    for (int i = tx; i < kQueryTile * nw; i += kRuleTile) {
      const int qq = i / nw, ww = i % nw, q = q0 + qq;
      s_b[qq][ww] = q < n_queries ? baskets[(size_t)q * n_words + w0 + ww] : 0u;
    }
    __syncthreads();
    for (int ww = 0; ww < nw; ++ww) {
      const uint32_t a = s_a[ww][tx];
      const uint32_t c = kExclude ? s_c[ww][tx] : 0u;
#pragma unroll
      for (int q = 0; q < kQueryTile; ++q) {
        const uint32_t b = s_b[q][ww];
        if ((a & b) != a) ante_in &= ~(1u << q);
        if (kExclude && (c & b) != c) cons_in &= ~(1u << q);
      }
    }
    __syncthreads();
  }
  const int r = r0 + tx;
  if (r >= n_rules) return;
  const float s = score[r];
  const unsigned fire = kExclude ? (ante_in & ~cons_in) : ante_in;
  const int nq = min(kQueryTile, n_queries - q0);
  for (int q = 0; q < nq; ++q)
    out[(size_t)(q0 + q) * n_rules + r] = ((fire >> q) & 1u) ? s : neg_inf();
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
  const dim3 grid(ceil_div(n_rules, kRuleTile), ceil_div(n_queries, kQueryTile));
  const uint32_t* a = static_cast<const uint32_t*>(ante);
  const uint32_t* c = static_cast<const uint32_t*>(cons);
  const float* sc = static_cast<const float*>(score);
  const uint32_t* b = static_cast<const uint32_t*>(baskets);
  float* o = static_cast<float*>(out);
  if (exclude)
    rule_scores_kernel<true><<<grid, kRuleTile, 0, s>>>(
        a, c, sc, n_rules, b, n_queries, n_words, o);
  else
    rule_scores_kernel<false><<<grid, kRuleTile, 0, s>>>(
        a, c, sc, n_rules, b, n_queries, n_words, o);
  return cudaGetLastError();
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
