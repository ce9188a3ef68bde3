// Hand-written Hopper (sm_90a) kernels for the support-counting hot spot.
//
// One kernel for each TPU (Pallas) counting kernel of the JAX package.  Each
// computes what its TPU kernel computes; none copies its block structure.
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

// ---------------------------------------------------------------------------
// support_count — replaces support_count.py:_support_count_kernel.
//
// count[i] = Σ_j AND_w((c[i,w] & t[j,w]) == c[i,w]): the horizontal subset
// test of every candidate against every transaction, W = ceil(I/32) words.
//
// Bound on the H100: the integer ALUs, C·T·(3W+1) operations; the bytes
// (C + T)·W·4 are small beside them.
// Design: a block holds a tile of kHorzBC = 32 candidates in shared memory
// (read as broadcasts) and loops over its slice of transaction rows, one row
// per thread held in W registers.  For each candidate the warp's 32 match
// bits become one __ballot_sync, and lane b keeps candidate b's count, so no
// per-candidate register array is needed.  Rows past the slice end are masked
// in the kernel: no zero-row padding, so an empty candidate counts exactly
// the real transactions, as the reference's corrected count does.
// ---------------------------------------------------------------------------

constexpr int kHorzBC = 32;  // candidates per block: one per lane

template <int W>
__global__ void __launch_bounds__(kThreads)
support_count_kernel(const uint32_t* __restrict__ cands, int n_cands,
                     const uint32_t* __restrict__ txns, int n_txns,
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
#pragma unroll 4
    for (int b = 0; b < kHorzBC; ++b) {
      bool ok = real;
#pragma unroll
      for (int w = 0; w < W; ++w) ok = ok && ((s_c[b][w] & t[w]) == s_c[b][w]);
      const unsigned votes = __ballot_sync(0xffffffffu, ok);
      if (lane == b) mine += __popc(votes);
    }
  }
  atomicAdd(&s_cnt[lane], mine);
  __syncthreads();
  if (threadIdx.x < nc) atomicAdd(out + c0 + threadIdx.x, s_cnt[threadIdx.x]);
}

template <int W>
cudaError_t launch_support_count(const uint32_t* cands, int n_cands,
                                 const uint32_t* txns, int n_txns,
                                 int32_t* out, cudaStream_t stream) {
  const int bx = ceil_div(n_cands, kHorzBC);
  int splits, per;
  split_axis(n_txns, bx, kThreads, &splits, &per);
  support_count_kernel<W><<<dim3(bx, splits), kThreads, 0, stream>>>(
      cands, n_cands, txns, n_txns, per, out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// overlap_count — the matmul forms.  Replaces
//   support_count.py:_support_count_matmul_kernel  (a = candidate bit planes,
//     width = popcount(candidate), b = transaction bit planes, no valid), and
//   vertical_count.py:_vertical_matmul_kernel      (a = 0/1 membership rows,
//     width = distinct items per candidate, b = item planes per transaction,
//     valid = the valid-transaction bits).
//
// count[m] = Σ_n [ Σ_k a[m,k]·b[n,k] == width[m]  ∧  valid[n] ]  over n < N.
// a (M, K) and b (N, K) are int8 0/1 planes, read as int32 words of 4 planes
// (K4 = K/4 words a row).
//
// Bound on the H100: the same work as an (M, K) × (K, N) int8 product,
// 2·M·N·K operations, against 1,979 TOP/s of int8 tensor cores.  This first
// version does not reach the tensor cores: it runs __dp4a (4 multiply-adds in
// one instruction) on the CUDA cores, far below that peak; mma.sync/wgmma are
// later work.
// Design: a 64×64 output tile per block and a 4×4 sub-tile per thread, K
// streamed through shared memory 16 words (64 planes) at a time; the compare
// with width and valid, and the sum over n, happen in registers, so the
// (M, N) overlap matrix never reaches device memory.  Rows m ≥ M take width
// −1, which no overlap equals: the counterpart of the reference's nreal = −1
// poisoning of padded rows.  The transaction axis is split across blocks and
// merged with atomicAdd.
// ---------------------------------------------------------------------------

constexpr int kTM = 64, kTN = 64, kTK = 16;
// one loop stages a row of each tile, so the two tiles have as many rows
static_assert(kTM == kTN, "the staging loop walks a and b rows together");

__global__ void __launch_bounds__(kThreads)
overlap_count_kernel(const int32_t* __restrict__ a,
                     const int32_t* __restrict__ width, int m_rows,
                     const int32_t* __restrict__ b,
                     const int8_t* __restrict__ valid, int n_rows, int k4,
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
      const bool ok_n = n < n_end && (valid == nullptr || valid[n] != 0);
#pragma unroll
      for (int i = 0; i < 4; ++i) hits[i] += (ok_n && acc[i][j] == wd[i]) ? 1 : 0;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (hits[i]) atomicAdd(&s_cnt[ty * 4 + i], hits[i]);
  __syncthreads();
  if (threadIdx.x < kTM && m0 + threadIdx.x < m_rows)
    atomicAdd(out + m0 + threadIdx.x, s_cnt[threadIdx.x]);
}

cudaError_t launch_overlap_count(const void* a, const void* width,
                                 const void* b, const void* valid, int m_rows,
                                 int n_rows, int k4, void* out,
                                 cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)m_rows * sizeof(int32_t),
                                    stream);
  if (err != cudaSuccess) return err;
  const int bx = ceil_div(m_rows, kTM);
  int splits, per;
  split_axis(n_rows, bx, kTN, &splits, &per);
  overlap_count_kernel<<<dim3(bx, splits), kThreads, 0, stream>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(width),
      m_rows, static_cast<const int32_t*>(b),
      static_cast<const int8_t*>(valid), n_rows, k4, per,
      static_cast<int32_t*>(out));
  return cudaGetLastError();
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)n_cands * sizeof(int32_t), s);
  if (err != cudaSuccess) return err;
  const uint32_t* c = static_cast<const uint32_t*>(cands);
  const uint32_t* t = static_cast<const uint32_t*>(txns);
  int32_t* o = static_cast<int32_t*>(out);
  switch (n_words) {
    case 1: return launch_support_count<1>(c, n_cands, t, n_txns, o, s);
    case 2: return launch_support_count<2>(c, n_cands, t, n_txns, o, s);
    case 3: return launch_support_count<3>(c, n_cands, t, n_txns, o, s);
    case 4: return launch_support_count<4>(c, n_cands, t, n_txns, o, s);
    case 5: return launch_support_count<5>(c, n_cands, t, n_txns, o, s);
    case 6: return launch_support_count<6>(c, n_cands, t, n_txns, o, s);
    case 7: return launch_support_count<7>(c, n_cands, t, n_txns, o, s);
    case 8: return launch_support_count<8>(c, n_cands, t, n_txns, o, s);
    default: return cudaErrorInvalidValue;
  }
}

int support_count_matmul(const void* a, const void* width, const void* b,
                         int m_rows, int n_rows, int k4, void* out,
                         void* stream) {
  return launch_overlap_count(a, width, b, nullptr, m_rows, n_rows, k4, out,
                              static_cast<cudaStream_t>(stream));
}

int vertical_count_matmul(const void* a, const void* width, const void* b,
                          const void* valid, int m_rows, int n_rows, int k4,
                          void* out, void* stream) {
  return launch_overlap_count(a, width, b, valid, m_rows, n_rows, k4, out,
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
