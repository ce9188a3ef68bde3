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
// The same matrix from bit planes: with bb (Q, 32W), ab and cb (R, 32W) int8
// 0/1 planes, ante[r] ⊆ basket[q] iff Σ_k bb[q,k]·ab[r,k] == aw[r] (the
// antecedent's popcount), and cons[r] ⊄ basket[q] iff the consequent overlap
// != cw[r].  Planes are read as int32 words of 4 (K4 = 8W words a row).
//
// The tiling is overlap_count's (common.cuh): a 64 × 64 (query, rule) output
// tile per block, a 4 × 4 sub-tile per thread, K streamed through shared
// memory 16 words at a time and __dp4a on the CUDA cores.  Both overlaps are
// accumulated side by side from one staged basket tile; the compares and the
// select happen in registers, so neither (Q, R) overlap matrix reaches device
// memory — only the selected scores do.  The int8 tensor cores are later
// work; the output bytes bound this function anyway.
// ---------------------------------------------------------------------------

template <bool kExclude>
__global__ void __launch_bounds__(kThreads)
rule_scores_matmul_kernel(const int32_t* __restrict__ ab,
                          const int32_t* __restrict__ aw,
                          const int32_t* __restrict__ cb,
                          const int32_t* __restrict__ cw,
                          const float* __restrict__ score, int n_rules,
                          const int32_t* __restrict__ bb, int n_queries,
                          int k4, float* __restrict__ out) {
  __shared__ int32_t s_q[kTK][kTM + 1];
  __shared__ int32_t s_a[kTK][kTN + 1];
  __shared__ int32_t s_c[kTK][kTN + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.y * kTM, r0 = blockIdx.x * kTN;
  int acc_a[4][4], acc_c[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_a[i][j] = acc_c[i][j] = 0;
  for (int kk = 0; kk < k4; kk += kTK) {
    for (int i = threadIdx.x; i < kTM * kTK; i += kThreads) {
      const int row = i / kTK, k = i % kTK, kw = kk + k;
      const int q = q0 + row, r = r0 + row;
      const bool r_in = r < n_rules && kw < k4;
      s_q[k][row] = (q < n_queries && kw < k4) ? bb[(size_t)q * k4 + kw] : 0;
      s_a[k][row] = r_in ? ab[(size_t)r * k4 + kw] : 0;
      if (kExclude) s_c[k][row] = r_in ? cb[(size_t)r * k4 + kw] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTK; ++k) {
      int qv[4], av[4], cv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = s_q[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        av[j] = s_a[k][tx * 4 + j];
        cv[j] = kExclude ? s_c[k][tx * 4 + j] : 0;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc_a[i][j] = __dp4a(qv[i], av[j], acc_a[i][j]);
          if (kExclude) acc_c[i][j] = __dp4a(qv[i], cv[j], acc_c[i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = r0 + tx * 4 + j;
    if (r >= n_rules) continue;
    const int wa = aw[r], wc = kExclude ? cw[r] : 0;
    const float s = score[r];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + ty * 4 + i;
      if (q >= n_queries) continue;
      const bool fire = acc_a[i][j] == wa && (!kExclude || acc_c[i][j] != wc);
      out[(size_t)q * n_rules + r] = fire ? s : neg_inf();
    }
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

int rule_scores_matmul(const void* ab, const void* aw, const void* cb,
                       const void* cw, const void* score, int n_rules,
                       const void* bb, int n_queries, int k4, int exclude,
                       void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(ceil_div(n_rules, kTN), ceil_div(n_queries, kTM));
  const int32_t* a = static_cast<const int32_t*>(ab);
  const int32_t* a_w = static_cast<const int32_t*>(aw);
  const int32_t* c = static_cast<const int32_t*>(cb);
  const int32_t* c_w = static_cast<const int32_t*>(cw);
  const float* sc = static_cast<const float*>(score);
  const int32_t* b = static_cast<const int32_t*>(bb);
  float* o = static_cast<float*>(out);
  if (exclude)
    rule_scores_matmul_kernel<true><<<grid, kThreads, 0, s>>>(
        a, a_w, c, c_w, sc, n_rules, b, n_queries, k4, o);
  else
    rule_scores_matmul_kernel<false><<<grid, kThreads, 0, s>>>(
        a, a_w, c, c_w, sc, n_rules, b, n_queries, k4, o);
  return cudaGetLastError();
}

}  // extern "C"
