// Hand-written Hopper (sm_90a) kernels for the support-counting hot spot.
//
// One kernel for each TPU (Pallas) counting kernel of the JAX package.  Each
// computes what its TPU kernel computes; none copies its block structure.
// vertical_count is here; support_count runs subset_count_kernel and the two
// matmul forms overlap_count_kernel, which live in common.cuh because the
// streaming kernels (delta_count.cu) run them too.
// Every C entry point zeroes its output, launches on the caller's stream and
// returns cudaGetLastError(); the Python wrappers in repro_torch/kernels/
// allocate the output, check device, dtype, shape and contiguity, and raise
// on a non-zero return.
//
// The TPU kernels carry a sum along a sequential grid axis.  Blocks on Hopper
// run in parallel and in no order, so the transaction axis is split across
// blocks (gridDim.y) and the partial counts meet in int32 atomicAdd.  Integer
// sums do not depend on order: every count stays bit-exact.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "common.cuh"

namespace {

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// vertical_count — replaces vertical_count.py:_vertical_count_kernel.
//
// count[c] = Σ_t popcount(AND_j vdb[idx[c, j], t]) over the item-major
// bitmaps vdb (I+1, Tw); row I is the valid-transaction mask and the AND
// identity that pads short candidates.
//
// Bound on the H100: the integer ALUs.  The bytes that must move are the
// vertical DB once, (I+1)·Tw·4 (4.8 MB at the c20d200k phase shape, which
// stays in the 50 MB L2), but every candidate re-reads kmax rows of Tw words
// and ANDs and popcounts them: C·Tw·(kmax+2) int32 operations.
// Design: a block takes kVertBC candidates and loads its own idx rows into
// shared memory (the TPU kernel's scalar prefetch has no counterpart here);
// each thread owns words of the transaction axis, so a warp reads 128
// contiguous bytes of each row; the AND of the kmax rows stays in a register,
// __popc counts it, a warp shuffle and one shared-memory pass reduce the
// block, and one atomicAdd per candidate merges the transaction slices.  The
// ragged Tw edge is masked in the loop bound: no zero padding of the DB.
// ---------------------------------------------------------------------------

constexpr int kVertBC = 4;   // candidates per block

__global__ void __launch_bounds__(kThreads)
vertical_count_kernel(const uint32_t* __restrict__ vdb, int tw,
                      const int32_t* __restrict__ idx, int n_cands, int kmax,
                      int words_per_split, int32_t* __restrict__ out) {
  extern __shared__ int32_t s_rows[];          // kVertBC * kmax row ids
  __shared__ int s_part[kWarps][kVertBC];
  const int c0 = blockIdx.x * kVertBC;
  const int nc = min(kVertBC, n_cands - c0);
  for (int i = threadIdx.x; i < nc * kmax; i += kThreads)
    s_rows[i] = idx[(size_t)c0 * kmax + i];
  __syncthreads();

  const int t_begin = blockIdx.y * words_per_split;
  const int t_end = min(tw, t_begin + words_per_split);
  int cnt[kVertBC];
#pragma unroll
  for (int b = 0; b < kVertBC; ++b) cnt[b] = 0;
  for (int t = t_begin + threadIdx.x; t < t_end; t += kThreads) {
#pragma unroll
    for (int b = 0; b < kVertBC; ++b) {
      if (b < nc) {
        uint32_t acc = 0xffffffffu;
        for (int j = 0; j < kmax; ++j)
          acc &= __ldg(vdb + (size_t)s_rows[b * kmax + j] * tw + t);
        cnt[b] += __popc(acc);
      }
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int b = 0; b < kVertBC; ++b) {
    const int v = warp_sum(cnt[b]);
    if (lane == 0) s_part[warp][b] = v;
  }
  __syncthreads();
  if (threadIdx.x < nc) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += s_part[w][threadIdx.x];
    atomicAdd(out + c0 + threadIdx.x, s);
  }
}

}  // namespace

extern "C" {

int vertical_count(const void* vdb, int tw, const void* idx, int n_cands,
                   int kmax, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)n_cands * sizeof(int32_t), s);
  if (err != cudaSuccess) return err;
  const int bx = ceil_div(n_cands, kVertBC);
  int splits, per;
  split_axis(tw, bx, kThreads, &splits, &per);
  const size_t smem = (size_t)kVertBC * kmax * sizeof(int32_t);
  vertical_count_kernel<<<dim3(bx, splits), kThreads, smem, s>>>(
      static_cast<const uint32_t*>(vdb), tw, static_cast<const int32_t*>(idx),
      n_cands, kmax, per, static_cast<int32_t*>(out));
  return cudaGetLastError();
}

int support_count(const void* cands, const void* txns, int n_cands,
                  int n_txns, int n_words, void* out, void* stream) {
  return launch_subset_count<false>(cands, txns, nullptr, n_cands, n_txns,
                                    n_words, out,
                                    static_cast<cudaStream_t>(stream));
}

int support_count_matmul(const void* a, const void* width, const void* b,
                         int m_rows, int n_rows, int k4, void* out,
                         void* stream) {
  return launch_overlap_count<int8_t>(a, width, b, nullptr, m_rows, n_rows, k4,
                                      out, static_cast<cudaStream_t>(stream));
}

int vertical_count_matmul(const void* a, const void* width, const void* b,
                          const void* valid, int m_rows, int n_rows, int k4,
                          void* out, void* stream) {
  return launch_overlap_count<int8_t>(a, width, b, valid, m_rows, n_rows, k4,
                                      out, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
