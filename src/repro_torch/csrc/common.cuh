// Pieces shared by the port's CUDA sources (counting.cu, delta_count.cu,
// rule_match.cu): launch geometry and the two counting
// kernels that the horizontal TPU kernels map onto — subset_count (the
// popcount-AND forms, plain and sign-weighted) and overlap_count (the
// bit-plane matmul forms).
//
// Each source includes this header into its own anonymous namespace, so
// every library carries its own copy; kernels/_build.py hashes this header
// with each source, so an edit here rebuilds all of them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// grid size to aim for: about 8 resident blocks on each of the H100's 132 SMs
constexpr int kTargetBlocks = 1024;

inline int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// Cut an axis of n items into gridDim.y slices of `per` items each (a
// multiple of `quantum`), enough slices for the grid to reach kTargetBlocks
// but never a slice shorter than one quantum.
inline void split_axis(int n, int blocks_x, int quantum, int* splits,
                       int* per) {
  const int items = n > 0 ? n : 1;
  int s = ceil_div(kTargetBlocks, blocks_x);
  const int most = ceil_div(items, quantum);
  if (s > most) s = most;
  if (s > 65535) s = 65535;
  if (s < 1) s = 1;
  *per = ceil_div(ceil_div(items, s), quantum) * quantum;
  *splits = ceil_div(items, *per);
}

// ---------------------------------------------------------------------------
// subset_count — the popcount-AND forms of the horizontal counting kernels.
// Replaces
//   support_count.py:_support_count_kernel  (kSigned = false), and
//   delta_count.py:_delta_count_kernel      (kSigned = true: each row
//     weighted by the slab's int32 sign, +1 added, −1 evicted, 0 padding).
//
// count[i] = Σ_j sign[j] · AND_w((c[i,w] & t[j,w]) == c[i,w]): the
// horizontal subset test of every candidate against every row, W =
// ceil(I/32) words, sign 1 when unsigned.
//
// Bound on the H100: the integer ALUs, C·T·(3W+1) operations; the bytes
// (C + T)·W·4 are small beside them.
// Design: a block holds a tile of kHorzBC = 32 candidates in shared memory
// (read as broadcasts) and loops over its slice of rows, one row per thread
// held in W registers.  For each candidate the warp's 32 matches are reduced
// in one instruction — __ballot_sync and __popc unsigned, __reduce_add_sync
// of the signs signed — and lane b keeps candidate b's count, so no
// per-candidate register array is needed.  Rows past the slice end are
// masked in the kernel: no zero-row padding, so an empty candidate counts
// exactly the real rows, as the reference's corrected count does; sign-0
// padding rows add 0.  The row axis is split across blocks and merged with
// one int32 atomicAdd per candidate and block: exact in any order.
// ---------------------------------------------------------------------------

constexpr int kHorzBC = 32;  // candidates per block: one per lane

template <int W, bool kSigned>
__global__ void __launch_bounds__(kThreads)
subset_count_kernel(const uint32_t* __restrict__ cands, int n_cands,
                    const uint32_t* __restrict__ txns,
                    const int32_t* __restrict__ sign, int n_txns,
                    int rows_per_split, int32_t* __restrict__ out) {
  __shared__ uint32_t s_c[kHorzBC][W];
  __shared__ int s_cnt[kHorzBC];
  const int c0 = blockIdx.x * kHorzBC;
  const int nc = min(kHorzBC, n_cands - c0);
  for (int i = threadIdx.x; i < kHorzBC * W; i += kThreads) {
    const int b = i / W, w = i % W;
    s_c[b][w] = b < nc ? cands[(size_t)(c0 + b) * W + w] : 0u;
  }
  if (threadIdx.x < kHorzBC) s_cnt[threadIdx.x] = 0;
  __syncthreads();

  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(n_txns, r_begin + rows_per_split);
  const int lane = threadIdx.x & 31;
  int mine = 0;                 // this warp's count of candidate `lane`
  for (int base = r_begin; base < r_end; base += kThreads) {
    const int r = base + threadIdx.x;
    const bool real = r < r_end;
    uint32_t t[W];
#pragma unroll
    for (int w = 0; w < W; ++w)
      t[w] = real ? __ldg(txns + (size_t)r * W + w) : 0u;
    const int s = (kSigned && real) ? __ldg(sign + r) : 0;
#pragma unroll 4
    for (int b = 0; b < kHorzBC; ++b) {
      bool ok = real;
#pragma unroll
      for (int w = 0; w < W; ++w) ok = ok && ((s_c[b][w] & t[w]) == s_c[b][w]);
      if constexpr (kSigned) {
        const int v = __reduce_add_sync(0xffffffffu, ok ? s : 0);
        if (lane == b) mine += v;
      } else {
        const unsigned votes = __ballot_sync(0xffffffffu, ok);
        if (lane == b) mine += __popc(votes);
      }
    }
  }
  atomicAdd(&s_cnt[lane], mine);
  __syncthreads();
  if (threadIdx.x < nc) atomicAdd(out + c0 + threadIdx.x, s_cnt[threadIdx.x]);
}

// The same count for any W, with the words taken kWideChunk at a time: the
// block stages a chunk of its 32 candidates' words in shared memory, each
// thread tests its row's words of that chunk, and bit b of a register keeps
// "candidate b ⊆ this row" across the chunks; the warp reductions then run
// on those bits as above.  Used past the register-tiled instances (W > 8,
// more than 256 items), so a row never has to fit in registers.
constexpr int kWideChunk = 8;

template <bool kSigned>
__global__ void __launch_bounds__(kThreads)
subset_count_wide_kernel(const uint32_t* __restrict__ cands, int n_cands,
                         const uint32_t* __restrict__ txns,
                         const int32_t* __restrict__ sign, int n_txns,
                         int n_words, int rows_per_split,
                         int32_t* __restrict__ out) {
  __shared__ uint32_t s_c[kHorzBC][kWideChunk];
  __shared__ int s_cnt[kHorzBC];
  const int c0 = blockIdx.x * kHorzBC;
  const int nc = min(kHorzBC, n_cands - c0);
  if (threadIdx.x < kHorzBC) s_cnt[threadIdx.x] = 0;
  __syncthreads();

  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(n_txns, r_begin + rows_per_split);
  const int lane = threadIdx.x & 31;
  int mine = 0;                 // this warp's count of candidate `lane`
  for (int base = r_begin; base < r_end; base += kThreads) {
    const int r = base + threadIdx.x;
    const bool real = r < r_end;
    unsigned in = real ? 0xffffffffu : 0u;   // bit b: cand c0 + b ⊆ row r
    for (int w0 = 0; w0 < n_words; w0 += kWideChunk) {
      const int nw = min(kWideChunk, n_words - w0);
      __syncthreads();          // the last chunk's reads are done
      for (int i = threadIdx.x; i < kHorzBC * kWideChunk; i += kThreads) {
        const int b = i / kWideChunk, w = i % kWideChunk;
        s_c[b][w] = (b < nc && w < nw)
                        ? cands[(size_t)(c0 + b) * n_words + w0 + w] : 0u;
      }
      __syncthreads();
      for (int w = 0; w < nw; ++w) {
        const uint32_t t =
            real ? __ldg(txns + (size_t)r * n_words + w0 + w) : 0u;
#pragma unroll
        for (int b = 0; b < kHorzBC; ++b)
          if ((s_c[b][w] & t) != s_c[b][w]) in &= ~(1u << b);
      }
    }
    const int s = (kSigned && real) ? __ldg(sign + r) : 0;
#pragma unroll 4
    for (int b = 0; b < kHorzBC; ++b) {
      const bool ok = (in >> b) & 1u;
      if constexpr (kSigned) {
        const int v = __reduce_add_sync(0xffffffffu, ok ? s : 0);
        if (lane == b) mine += v;
      } else {
        const unsigned votes = __ballot_sync(0xffffffffu, ok);
        if (lane == b) mine += __popc(votes);
      }
    }
  }
  atomicAdd(&s_cnt[lane], mine);
  __syncthreads();
  if (threadIdx.x < nc) atomicAdd(out + c0 + threadIdx.x, s_cnt[threadIdx.x]);
}

// W = 0 launches the chunked instance with n_words words
template <int W, bool kSigned>
cudaError_t launch_subset_count_w(const uint32_t* cands, int n_cands,
                                  const uint32_t* txns, const int32_t* sign,
                                  int n_txns, int n_words, int32_t* out,
                                  cudaStream_t stream) {
  const int bx = ceil_div(n_cands, kHorzBC);
  int splits, per;
  split_axis(n_txns, bx, kThreads, &splits, &per);
  const dim3 grid(bx, splits);
  if constexpr (W == 0)
    subset_count_wide_kernel<kSigned><<<grid, kThreads, 0, stream>>>(
        cands, n_cands, txns, sign, n_txns, n_words, per, out);
  else
    subset_count_kernel<W, kSigned><<<grid, kThreads, 0, stream>>>(
        cands, n_cands, txns, sign, n_txns, per, out);
  return cudaGetLastError();
}

// Zero the output and launch the instance for n_words: 1..8 keep a row in
// registers, wider rows take the chunked instance.
template <bool kSigned>
cudaError_t launch_subset_count(const void* cands, const void* txns,
                                const void* sign, int n_cands, int n_txns,
                                int n_words, void* out, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)n_cands * sizeof(int32_t), s);
  if (err != cudaSuccess) return err;
  const uint32_t* c = static_cast<const uint32_t*>(cands);
  const uint32_t* t = static_cast<const uint32_t*>(txns);
  const int32_t* g = static_cast<const int32_t*>(sign);
  int32_t* o = static_cast<int32_t*>(out);
  const int n = n_words;
  switch (n_words) {
    case 1: return launch_subset_count_w<1, kSigned>(c, n_cands, t, g, n_txns, n, o, s);
    case 2: return launch_subset_count_w<2, kSigned>(c, n_cands, t, g, n_txns, n, o, s);
    case 3: return launch_subset_count_w<3, kSigned>(c, n_cands, t, g, n_txns, n, o, s);
    case 4: return launch_subset_count_w<4, kSigned>(c, n_cands, t, g, n_txns, n, o, s);
    case 5: return launch_subset_count_w<5, kSigned>(c, n_cands, t, g, n_txns, n, o, s);
    case 6: return launch_subset_count_w<6, kSigned>(c, n_cands, t, g, n_txns, n, o, s);
    case 7: return launch_subset_count_w<7, kSigned>(c, n_cands, t, g, n_txns, n, o, s);
    case 8: return launch_subset_count_w<8, kSigned>(c, n_cands, t, g, n_txns, n, o, s);
    default:  // W > 8; W = 0 too, where every row holds the empty candidate
      return launch_subset_count_w<0, kSigned>(c, n_cands, t, g, n_txns, n, o, s);
  }
}

// ---------------------------------------------------------------------------
// overlap_count — the matmul forms of the counting kernels.  Replaces
//   support_count.py:_support_count_matmul_kernel  (a = candidate bit planes,
//     width = popcount(candidate), b = transaction bit planes, no weight),
//   vertical_count.py:_vertical_matmul_kernel      (a = 0/1 membership rows,
//     width = distinct items per candidate, b = item planes per transaction,
//     weight = the 0/1 valid-transaction bits, int8), and
//   delta_count.py:_delta_count_matmul_kernel      (as the first, weight =
//     the slab's int32 sign: +1 added, −1 evicted, 0 padding).
//
// count[m] = Σ_n weight[n] · [ Σ_k a[m,k]·b[n,k] == width[m] ]  over n < N,
// weight 1 when none is given.  a (M, K) and b (N, K) are int8 0/1 planes,
// read as int32 words of 4 planes (K4 = K/4 words a row).
//
// Bound on the H100: the same work as an (M, K) × (K, N) int8 product,
// 2·M·N·K operations, against 1,979 TOP/s of int8 tensor cores.  This first
// version does not reach the tensor cores: it runs __dp4a (4 multiply-adds in
// one instruction) on the CUDA cores, far below that peak; mma.sync/wgmma are
// later work.
// Design: a 64×64 output tile per block and a 4×4 sub-tile per thread, K
// streamed through shared memory 16 words (64 planes) at a time; the compare
// with width, the weight, and the sum over n happen in registers, so the
// (M, N) overlap matrix never reaches device memory.  Rows m ≥ M take width
// −1, which no overlap equals: the counterpart of the reference's nreal = −1
// poisoning of padded rows.  The n axis is split across blocks and merged
// with atomicAdd; integer sums do not depend on order, so counts stay exact.
// ---------------------------------------------------------------------------

constexpr int kTM = 64, kTN = 64, kTK = 16;
// one loop stages a row of each tile, so the two tiles have as many rows
static_assert(kTM == kTN, "the staging loop walks a and b rows together");

template <typename Weight>
__global__ void __launch_bounds__(kThreads)
overlap_count_kernel(const int32_t* __restrict__ a,
                     const int32_t* __restrict__ width, int m_rows,
                     const int32_t* __restrict__ b,
                     const Weight* __restrict__ weight, int n_rows, int k4,
                     int rows_per_split, int32_t* __restrict__ out) {
  __shared__ int32_t s_a[kTK][kTM + 1];
  __shared__ int32_t s_b[kTK][kTN + 1];
  __shared__ int s_cnt[kTM];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * kTM;
  if (threadIdx.x < kTM) s_cnt[threadIdx.x] = 0;
  int wd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    wd[i] = m < m_rows ? width[m] : -1;
  }
  int hits[4] = {0, 0, 0, 0};
  __syncthreads();

  const int n_begin = blockIdx.y * rows_per_split;
  const int n_end = min(n_rows, n_begin + rows_per_split);
  for (int n0 = n_begin; n0 < n_end; n0 += kTN) {
    int acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;
    for (int kk = 0; kk < k4; kk += kTK) {
      for (int i = threadIdx.x; i < kTM * kTK; i += kThreads) {
        const int r = i / kTK, k = i % kTK, kw = kk + k;
        const int m = m0 + r, n = n0 + r;
        s_a[k][r] = (m < m_rows && kw < k4) ? a[(size_t)m * k4 + kw] : 0;
        s_b[k][r] = (n < n_end && kw < k4) ? b[(size_t)n * k4 + kw] : 0;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kTK; ++k) {
        int av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = s_a[k][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = s_b[k][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      const int wn = n < n_end ? (weight == nullptr ? 1 : (int)weight[n]) : 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) hits[i] += (acc[i][j] == wd[i]) ? wn : 0;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (hits[i]) atomicAdd(&s_cnt[ty * 4 + i], hits[i]);
  __syncthreads();
  if (threadIdx.x < kTM && m0 + threadIdx.x < m_rows)
    atomicAdd(out + m0 + threadIdx.x, s_cnt[threadIdx.x]);
}

template <typename Weight>
cudaError_t launch_overlap_count(const void* a, const void* width,
                                 const void* b, const void* weight, int m_rows,
                                 int n_rows, int k4, void* out,
                                 cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)m_rows * sizeof(int32_t),
                                    stream);
  if (err != cudaSuccess) return err;
  const int bx = ceil_div(m_rows, kTM);
  int splits, per;
  split_axis(n_rows, bx, kTN, &splits, &per);
  overlap_count_kernel<Weight><<<dim3(bx, splits), kThreads, 0, stream>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(width),
      m_rows, static_cast<const int32_t*>(b),
      static_cast<const Weight*>(weight), n_rows, k4, per,
      static_cast<int32_t*>(out));
  return cudaGetLastError();
}

}  // namespace
