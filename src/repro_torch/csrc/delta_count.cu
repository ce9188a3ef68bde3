// Hand-written Hopper (sm_90a) kernels for streaming delta counting.
//
// A window update adds and evicts transactions; the build_slab wrapper
// (kernels/delta_count.py) stacks both into one (T, W) slab with an int32
// sign per row (+1 added, −1 evicted, 0 padding), and each tracked
// candidate's count moves by
//
//     delta[i] = Σ_j sign[j] · [cand[i] ⊆ slab[j]].
//
// Both entry points take the packed (C, W) candidate and (T, W) slab words
// and the (T,) signs, and count with the sign as a row weight:
//
// * delta_count         replaces delta_count.py:_delta_count_kernel: the
//                       popcount-AND subset test, subset_count_kernel<W>
//                       (W > 8: subset_count_wide_kernel); a warp adds
//                       the signs of its 32 rows that contain candidate b
//                       with one __reduce_add_sync.
// * delta_count_matmul  replaces delta_count.py:_delta_count_matmul_kernel:
//                       overlap == width weighted by the sign, the overlaps
//                       from the single-bit tensor cores (wgmma .b1
//                       AND-popcount, BGMMA) fed the packed words as they
//                       are — overlap_mma.cuh's weighted kBits instance,
//                       overlap_mma_kernel<kBits, true>.  K = 32·W bits:
//                       W ≤ 8 is one BGMMA k-step of 256 bits (the
//                       streaming shape, W = 4, is one), W > 8 takes the
//                       chunked path, a k-step a chunk.
//
// The TPU kernels revisit one (BC,) accumulator along a sequential slab grid
// axis; here the slab is split across blocks (gridDim.y) and the slices meet
// in one int32 atomicAdd per candidate and block.  Integer sums do not depend
// on order, so every delta stays exact.  Sign-0 padding rows contribute 0.
//
// Bound on the H100 at the streaming shape (about 28k padded tracked
// candidates against a 512-row slab): the popcount form's integer
// operations, C·T·(3W+1); the matmul form's 2·C·T·32W AND-popcount bit-ops
// at the b1 tensor cores' 8 × 1,979 TOP/s (PERF.md's probe), a couple of
// µs, so its time is the launch's and the compare epilogue's.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "common.cuh"
#include "overlap_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// subset_count — the popcount-AND form of delta counting.  Replaces
//   delta_count.py:_delta_count_kernel  (each row weighted by the slab's
//     int32 sign, +1 added, −1 evicted, 0 padding).
//
// count[i] = Σ_j sign[j] · AND_w((c[i,w] & t[j,w]) == c[i,w]): the
// horizontal subset test of every candidate against every row, W =
// ceil(I/32) words.
//
// Bound on the H100: the integer ALUs, C·T·(3W+1) operations; the bytes
// (C + T)·W·4 are small beside them.
// Design: a block holds a tile of kHorzBC = 32 candidates in shared memory
// (read as broadcasts) and loops over its slice of rows, one row per thread
// held in W registers.  For each candidate the warp's 32 signed matches are
// reduced in one __reduce_add_sync, and lane b keeps candidate b's count, so
// no per-candidate register array is needed.  Rows past the slice end are
// masked in the kernel; sign-0 padding rows add 0.  The row axis is split
// across blocks and merged with one int32 atomicAdd per candidate and block:
// exact in any order.
// ---------------------------------------------------------------------------

constexpr int kHorzBC = 32;  // candidates per block: one per lane

template <int W>
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
    const int s = real ? __ldg(sign + r) : 0;
#pragma unroll 4
    for (int b = 0; b < kHorzBC; ++b) {
      bool ok = real;
#pragma unroll
      for (int w = 0; w < W; ++w) ok = ok && ((s_c[b][w] & t[w]) == s_c[b][w]);
      const int v = __reduce_add_sync(0xffffffffu, ok ? s : 0);
      if (lane == b) mine += v;
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
    const int s = real ? __ldg(sign + r) : 0;
#pragma unroll 4
    for (int b = 0; b < kHorzBC; ++b) {
      const bool ok = (in >> b) & 1u;
      const int v = __reduce_add_sync(0xffffffffu, ok ? s : 0);
      if (lane == b) mine += v;
    }
  }
  atomicAdd(&s_cnt[lane], mine);
  __syncthreads();
  if (threadIdx.x < nc) atomicAdd(out + c0 + threadIdx.x, s_cnt[threadIdx.x]);
}

// W = 0 launches the chunked instance with n_words words
template <int W>
cudaError_t launch_subset_count_w(const uint32_t* cands, int n_cands,
                                  const uint32_t* txns, const int32_t* sign,
                                  int n_txns, int n_words, int32_t* out,
                                  cudaStream_t stream) {
  const int bx = ceil_div(n_cands, kHorzBC);
  int splits, per;
  split_axis(n_txns, bx, kThreads, &splits, &per);
  const dim3 grid(bx, splits);
  if constexpr (W == 0)
    subset_count_wide_kernel<<<grid, kThreads, 0, stream>>>(
        cands, n_cands, txns, sign, n_txns, n_words, per, out);
  else
    subset_count_kernel<W><<<grid, kThreads, 0, stream>>>(
        cands, n_cands, txns, sign, n_txns, per, out);
  return cudaGetLastError();
}

// Zero the output and launch the instance for n_words: 1..8 keep a row in
// registers, wider rows take the chunked instance.
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
    case 1: return launch_subset_count_w<1>(c, n_cands, t, g, n_txns, n, o, s);
    case 2: return launch_subset_count_w<2>(c, n_cands, t, g, n_txns, n, o, s);
    case 3: return launch_subset_count_w<3>(c, n_cands, t, g, n_txns, n, o, s);
    case 4: return launch_subset_count_w<4>(c, n_cands, t, g, n_txns, n, o, s);
    case 5: return launch_subset_count_w<5>(c, n_cands, t, g, n_txns, n, o, s);
    case 6: return launch_subset_count_w<6>(c, n_cands, t, g, n_txns, n, o, s);
    case 7: return launch_subset_count_w<7>(c, n_cands, t, g, n_txns, n, o, s);
    case 8: return launch_subset_count_w<8>(c, n_cands, t, g, n_txns, n, o, s);
    default:  // W > 8; W = 0 too, where every row holds the empty candidate
      return launch_subset_count_w<0>(c, n_cands, t, g, n_txns, n, o, s);
  }
}

}  // namespace

extern "C" {

int delta_count(const void* cands, const void* txns, const void* sign,
                int n_cands, int n_txns, int n_words, void* out,
                void* stream) {
  return launch_subset_count(cands, txns, sign, n_cands, n_txns,
                                   n_words, out,
                                   static_cast<cudaStream_t>(stream));
}

int delta_count_matmul(const void* cands, const void* txns, const void* sign,
                       int n_cands, int n_txns, int n_words, void* out,
                       void* stream) {
  OverlapMmaArgs p{};
  p.a = static_cast<const uint32_t*>(cands);
  p.b = static_cast<const uint32_t*>(txns);
  p.weight = static_cast<const int32_t*>(sign);
  p.out = static_cast<int32_t*>(out);
  p.n_cands = n_cands;
  p.n_rows = n_txns;
  p.n_words = n_words;
  return launch_overlap_mma<kBits, true>(p, 4 * n_words,
                                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
