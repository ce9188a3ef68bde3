// Hand-written Hopper (sm_90a) kernels for the support-counting hot spot.
//
// One kernel for each TPU (Pallas) counting kernel of the JAX package.  Each
// computes what its TPU kernel computes; none copies its block structure.
// vertical_count is here; the other three run overlap_mma_kernel
// (overlap_mma.cuh) straight from the packed words: support_count and
// support_count_matmul on the single-bit tensor cores (popc(c & t) ==
// popc(c) iff c ⊆ t), vertical_count_matmul on the int8 tensor cores.
// Every C entry point writes its whole output, launches on the caller's
// stream and returns cudaGetLastError(); the Python wrappers in
// repro_torch/kernels/ allocate the output, check device, dtype, shape and
// contiguity, and raise on a non-zero return.
//
// The TPU kernels carry a sum along a sequential grid axis.  Blocks on Hopper
// run in parallel and in no order, so where one block does not own a
// candidate's whole transaction axis, the axis is split across blocks
// (gridDim.y) and the partial counts meet in int32 atomicAdd on a zeroed
// output.  Integer sums do not depend on order: every count stays bit-exact.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <mutex>

#include "common.cuh"
#include "overlap_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// vertical_count — replaces vertical_count.py:_vertical_count_kernel.
//
// count[c] = Σ_t popcount(AND_j vdb[idx[c, j], t]) over the item-major
// bitmaps vdb (I+1, Tw); row I is the valid-transaction mask and the AND
// identity that pads short candidates.
//
// Bound on the H100: the bytes that must move are the vertical DB once,
// (I+1)·Tw·4 (4.8 MB at the c20d200k phase shape, which stays in the 50 MB
// L2), but every candidate ANDs kmax rows of Tw words and popcounts them.
// Read straight from L2 for every candidate (kmax rows each), that is
// C·kmax·Tw·4 bytes, 3.07 GB a launch at c20d200k: L2 bandwidth, not the
// integer work, then sets the time.  Staged in shared memory, the same
// words come at 128 bytes a clock an SM, and the popcounts at 16 a clock
// an SM (__popc's rate on compute capability 9.0).
//
// Design (vertical_tile_kernel): a block takes a chunk of kVertChunk = 1024
// candidates, four a thread, neighbouring lanes on neighbouring candidates,
// and walks a slice of the transaction words a tile at a time.  A tile is
// all I+1 rows over 2^tile_shift words, staged by cp.async into one of two
// shared-memory buffers while the other is counted.  Rows are padded to an
// odd pitch, so lanes reading different rows at one word hit different
// banks (row mod 32) and lanes reading one row read a broadcast.  A thread
// keeps its candidates' row offsets and counts in registers (KMAX, the slot
// count, is a template argument up to kVertMaxK) and ANDs, popcounts and
// adds one word at a time.  Each chunk reads the DB from L2 once:
// vdb bytes × ceil(C / 1024) a launch, 193 MB at c20d200k.  One block
// owning a candidate's whole transaction axis stores its count; slices of
// it meet in one atomicAdd per candidate and block after a memset.  Words
// past Tw are zero-filled by the copy, so the ragged edge counts 0.
//
// Where the I+1 rows of even an 8-word tile do not fit twice in a block's
// shared memory (I+1 > 3,228 on the H100), or kmax > kVertMaxK, the entry
// point takes vertical_l2_kernel, which reads each candidate's rows from
// L2.  The choice is made from the shape alone.
// ---------------------------------------------------------------------------

constexpr int kVertCPT = 4;                       // candidates a thread
constexpr int kVertChunk = kThreads * kVertCPT;   // candidates a block
constexpr int kVertMaxK = 8;    // slots of the tiled instances

__device__ __forceinline__ void cp_async_4(uint32_t* dst, const uint32_t* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <int KMAX>
__global__ void __launch_bounds__(kThreads)
vertical_tile_kernel(const uint32_t* __restrict__ vdb, int n_rows, int tw,
                     const int32_t* __restrict__ idx, int n_cands,
                     int tile_shift, int tiles_per_split, int merge,
                     int32_t* __restrict__ out) {
  extern __shared__ uint32_t s_tile[];     // two buffers of n_rows × pitch
  const int tile_w = 1 << tile_shift;
  const int pitch = tile_w | 1;
  const int buf_words = n_rows * pitch;
  const int n_tiles = (tw + tile_w - 1) >> tile_shift;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  int off[kVertCPT][KMAX];                 // shared-memory row offsets
  uint32_t cnt[kVertCPT];
  const int c0 = blockIdx.x * kVertChunk + threadIdx.x;
#pragma unroll
  for (int b = 0; b < kVertCPT; ++b) {
    const int c = c0 + b * kThreads;
    cnt[b] = 0;
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      off[b][j] = c < n_cands ? __ldg(idx + (size_t)c * KMAX + j) * pitch : 0;
  }

  // tile t into buffer buf, one 4-byte copy a word, coalesced along a row
  auto stage = [&](int t, int buf) {
    uint32_t* dst = s_tile + buf * buf_words;
    const int w0 = t << tile_shift;
    const int n = n_rows << tile_shift;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int r = i >> tile_shift, w = i & (tile_w - 1);
      const bool in = w0 + w < tw;
      cp_async_4(dst + r * pitch + w, vdb + (size_t)r * tw + (in ? w0 + w : 0),
                 in ? 4 : 0);
    }
  };

  if (t_begin < t_end) stage(t_begin, 0);
  cp_async_commit();
  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    if (t + 1 < t_end) stage(t + 1, buf ^ 1);
    cp_async_commit();                     // empty at the last tile
    cp_async_wait_1();                     // tile t has landed
    __syncthreads();
    const uint32_t* s = s_tile + buf * buf_words;
    for (int w = 0; w < tile_w; w += 8) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
#pragma unroll
        for (int b = 0; b < kVertCPT; ++b) {
          uint32_t acc = s[off[b][0] + w + u];
#pragma unroll
          for (int j = 1; j < KMAX; ++j) acc &= s[off[b][j] + w + u];
          cnt[b] += __popc(acc);
        }
      }
    }
    __syncthreads();                       // buffer buf is free again
  }
#pragma unroll
  for (int b = 0; b < kVertCPT; ++b) {
    const int c = c0 + b * kThreads;
    if (c < n_cands) {
      if (merge) atomicAdd(out + c, (int)cnt[b]);
      else out[c] = (int)cnt[b];
    }
  }
}

// The large-shape instance: a block takes kVertBC candidates and reads
// their rows from L2 (__ldg), each thread a word of the transaction axis;
// a warp shuffle and one shared-memory pass reduce the block, and one
// atomicAdd per candidate merges the transaction slices.
constexpr int kVertBC = 4;   // candidates per block

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
vertical_l2_kernel(const uint32_t* __restrict__ vdb, int tw,
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

// A block's shared-memory limit on this card, read once a process (0 if it
// cannot be read).
inline size_t smem_optin() {
  static const size_t most = []() -> size_t {
    int dev, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
      return 0;
    return (size_t)n;
  }();
  return most;
}

inline size_t vertical_tile_bytes(int n_rows, int tile_shift) {
  return 2 * (size_t)n_rows * ((1 << tile_shift) | 1) * sizeof(uint32_t);
}

// The tile width (log2 words) for n_rows rows and kmax slots: the widest of
// 32, 16 and 8 words whose two buffers leave room for two blocks an SM,
// else 8 words at one block an SM; -1 takes vertical_l2_kernel.
inline int vertical_tile_shift(int n_rows, int kmax) {
  if (kmax > kVertMaxK) return -1;
  const size_t most = smem_optin();
  for (int sh = 5; sh >= 3; --sh)
    if (vertical_tile_bytes(n_rows, sh) <= most / 2) return sh;
  return vertical_tile_bytes(n_rows, 3) <= most ? 3 : -1;
}

template <int KMAX>
cudaError_t launch_vertical_tile(const uint32_t* vdb, int n_rows, int tw,
                                 const int32_t* idx, int n_cands,
                                 int tile_shift, int32_t* out,
                                 cudaStream_t s) {
  const size_t smem = vertical_tile_bytes(n_rows, tile_shift);
  // the limit is raised and the occupancy read where a launch needs more
  // shared memory than the one before: never again at a repeated shape
  static std::mutex mu;
  static size_t raised = 0, occ_smem = 0;
  static int occ = 1;
  int blocks_per_sm;
  {
    std::lock_guard<std::mutex> lock(mu);
    cudaError_t err;
    if (smem > raised) {
      if ((err = cudaFuncSetAttribute(
               vertical_tile_kernel<KMAX>,
               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
          cudaSuccess)
        return err;
      raised = smem;
    }
    if (smem != occ_smem) {
      if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &occ, vertical_tile_kernel<KMAX>, kThreads, smem)) !=
          cudaSuccess)
        return err;
      occ_smem = smem;
    }
    blocks_per_sm = occ > 0 ? occ : 1;
  }
  // one wave: the candidate chunks times the transaction slices fill the
  // resident blocks of every SM, each slice whole tiles
  const int n_tiles = ceil_div(tw, 1 << tile_shift);
  const int bx = ceil_div(n_cands, kVertChunk);
  const int slots = blocks_per_sm * sm_count();
  int splits = slots / bx;
  splits = splits < 1 ? 1 : (splits > n_tiles ? n_tiles : splits);
  const int per = ceil_div(n_tiles, splits);
  splits = ceil_div(n_tiles, per);
  const int merge = splits > 1;
  if (merge) {
    cudaError_t err =
        cudaMemsetAsync(out, 0, (size_t)n_cands * sizeof(int32_t), s);
    if (err != cudaSuccess) return err;
  }
  vertical_tile_kernel<KMAX><<<dim3(bx, splits), kThreads, smem, s>>>(
      vdb, n_rows, tw, idx, n_cands, tile_shift, per, merge, out);
  return cudaGetLastError();
}

cudaError_t launch_vertical_l2(const uint32_t* vdb, int tw,
                               const int32_t* idx, int n_cands, int kmax,
                               int32_t* out, cudaStream_t s) {
  cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)n_cands * sizeof(int32_t), s);
  if (err != cudaSuccess) return err;
  const int bx = ceil_div(n_cands, kVertBC);
  int splits, per;
  split_axis(tw, bx, kThreads, &splits, &per);
  const size_t smem = (size_t)kVertBC * kmax * sizeof(int32_t);
  vertical_l2_kernel<<<dim3(bx, splits), kThreads, smem, s>>>(
      vdb, tw, idx, n_cands, kmax, per, out);
  return cudaGetLastError();
}

// The two forms that count (C, W) candidate words against (T, W)
// transaction words, both on the single-bit instance: a word is 4 bytes of
// K, taken into the tiles as it is.
int launch_words(const void* cands, const void* txns, int n_cands,
                 int n_txns, int n_words, void* out, void* stream) {
  OverlapMmaArgs p{};
  p.a = static_cast<const uint32_t*>(cands);
  p.b = static_cast<const uint32_t*>(txns);
  p.out = static_cast<int32_t*>(out);
  p.n_cands = n_cands;
  p.n_rows = n_txns;
  p.n_words = n_words;
  return launch_overlap_mma<kBits>(p, 4 * n_words,
                                   static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

int vertical_count(const void* vdb, int n_rows, int tw, const void* idx,
                   int n_cands, int kmax, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* v = static_cast<const uint32_t*>(vdb);
  const int32_t* i = static_cast<const int32_t*>(idx);
  int32_t* o = static_cast<int32_t*>(out);
  if (tw <= 0 || n_cands <= 0)   // no transactions: every count is 0
    return cudaMemsetAsync(out, 0, (size_t)(n_cands > 0 ? n_cands : 0) *
                                       sizeof(int32_t), s);
  if (sm_count() == 0) return cudaErrorNoDevice;
  const int sh = vertical_tile_shift(n_rows, kmax);
  switch (sh < 0 ? 0 : kmax) {
    case 1: return launch_vertical_tile<1>(v, n_rows, tw, i, n_cands, sh, o, s);
    case 2: return launch_vertical_tile<2>(v, n_rows, tw, i, n_cands, sh, o, s);
    case 3: return launch_vertical_tile<3>(v, n_rows, tw, i, n_cands, sh, o, s);
    case 4: return launch_vertical_tile<4>(v, n_rows, tw, i, n_cands, sh, o, s);
    case 5: return launch_vertical_tile<5>(v, n_rows, tw, i, n_cands, sh, o, s);
    case 6: return launch_vertical_tile<6>(v, n_rows, tw, i, n_cands, sh, o, s);
    case 7: return launch_vertical_tile<7>(v, n_rows, tw, i, n_cands, sh, o, s);
    case 8: return launch_vertical_tile<8>(v, n_rows, tw, i, n_cands, sh, o, s);
    default: return launch_vertical_l2(v, tw, i, n_cands, kmax, o, s);
  }
}

// support_count — replaces support_count.py:_support_count_kernel.  The
// popcount-AND subset test on the b1 tensor cores: the overlap of a
// candidate with a transaction is popc(c & t), one BGMMA product over 256
// bits of K, and c ⊆ t iff it equals popc(c).  Bound on the H100: the
// compare epilogue on the CUDA cores (C·T compares), beside which the
// products (2·C·T·32W bit-ops at about 15.8 POP/s, PERF.md) are small.
int support_count(const void* cands, const void* txns, int n_cands,
                  int n_txns, int n_words, void* out, void* stream) {
  return launch_words(cands, txns, n_cands, n_txns, n_words, out, stream);
}

// support_count_matmul — replaces support_count.py:_support_count_matmul_
// kernel.  The bit-plane product Cb·Tbᵀ over 0/1 planes is, entry by entry,
// popc(c & t): the b1 tensor cores compute it from the packed words with no
// planes, exactly, and a candidate is contained iff it equals popc(c).  The
// same instance as support_count, so the same bound.
int support_count_matmul(const void* cands, const void* txns, int n_cands,
                         int n_txns, int n_words, void* out, void* stream) {
  return launch_words(cands, txns, n_cands, n_txns, n_words, out, stream);
}

int vertical_count_matmul(const void* vdb, int n_items, int tw,
                          const void* idx, int n_cands, int kmax, void* out,
                          void* stream) {
  OverlapMmaArgs p{};
  p.b = static_cast<const uint32_t*>(vdb);
  p.idx = static_cast<const int32_t*>(idx);
  p.out = static_cast<int32_t*>(out);
  p.n_cands = n_cands;
  p.n_rows = 32 * tw;
  p.kmax = kmax;
  p.n_items = n_items;
  p.tw = tw;
  return launch_overlap_mma<kVertical>(p, n_items,
                                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"
