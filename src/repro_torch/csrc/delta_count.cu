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
//                       (W > 8: subset_count_wide_kernel); a thread owns a
//                       candidate and adds the signs of the staged rows
//                       that contain it.
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
// axis; here a block walks the slab in a loop, and only where that leaves
// the card short of blocks is the slab split across blocks (gridDim.y), the
// slices meeting in one int32 atomicAdd per candidate and block.  Integer
// sums do not depend on order, so every delta stays exact.  Sign-0 padding
// rows contribute 0.
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
// (C + T)·W·4 are small beside them.  At the streaming shape (C = 28,672,
// T = 512, W = 4) the work is a few µs, so what costs is a block's start,
// its staging and any reduction across lanes or blocks.
// Design: a thread owns one candidate, its W words in registers (the W ≤ 8
// instances).  The block stages a tile of kSlabTile rows and their signs in
// shared memory, rows padded to 1, 2, 4 or 8 words, and each thread reads
// the rows as broadcasts (one 16-byte load a row at W = 4, four signs a
// 16-byte load) and adds a row's sign where no candidate bit is missing from
// it (one LOP3 a word): no warp reductions.  Longer slabs are staged a tile
// at a time.  Where one candidate a thread leaves the grid short of two
// blocks an SM, the warps of a block split each tile's rows into 2, 4 or 8
// parts, whose counts meet in shared memory; only past that is the slab
// split across blocks (gridDim.y), merged with one atomicAdd per candidate
// and block on a zeroed output.  One block owning a candidate's whole slab
// stores its count: one launch, no memset.  Sums wrap in uint32 as the
// reference's int32 sums do; rows past the slab are zero with sign 0.
// ---------------------------------------------------------------------------

constexpr int kSlabTile = 512;   // slab rows staged a tile
constexpr int kSplitQuantum = 32;  // slab rows a block's slice is cut in

template <int W>
__host__ __device__ constexpr int row_pitch() {
  return W == 1 ? 1 : W == 2 ? 2 : W <= 4 ? 4 : 8;
}

// Row r of a staged tile (pitch row_pitch<W>() words) into t, by vector
// loads: every lane reads the same row, so each load is one broadcast.
template <int W>
__device__ __forceinline__ void load_row(const uint32_t* s, int r,
                                         uint32_t (&t)[W]) {
  constexpr int P = row_pitch<W>();
  if constexpr (P == 1) {
    t[0] = s[r];
  } else if constexpr (P == 2) {
    const uint2 v = reinterpret_cast<const uint2*>(s)[r];
    t[0] = v.x;
    t[1] = v.y;
  } else {
#pragma unroll
    for (int q = 0; q < P / 4; ++q) {
      const uint4 v = reinterpret_cast<const uint4*>(s)[r * (P / 4) + q];
      if (4 * q < W) t[4 * q] = v.x;
      if (4 * q + 1 < W) t[4 * q + 1] = v.y;
      if (4 * q + 2 < W) t[4 * q + 2] = v.z;
      if (4 * q + 3 < W) t[4 * q + 3] = v.w;
    }
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
subset_count_kernel(const uint32_t* __restrict__ cands, int n_cands,
                    const uint32_t* __restrict__ txns,
                    const int32_t* __restrict__ sign, int n_txns, int parts,
                    int rows_per_split, int merge, int32_t* __restrict__ out) {
  constexpr int P = row_pitch<W>();
  __shared__ __align__(16) uint32_t s_t[kSlabTile * P];
  __shared__ __align__(16) int32_t s_sign[kSlabTile];
  __shared__ uint32_t s_part[kThreads];
  const int per_block = kThreads / parts;        // candidates a block
  const int local = threadIdx.x % per_block;
  const int part = threadIdx.x / per_block;      // one part a warp
  const int c = blockIdx.x * per_block + local;
  uint32_t cw[W];
#pragma unroll
  for (int w = 0; w < W; ++w)
    cw[w] = c < n_cands ? __ldg(cands + (size_t)c * W + w) : 0u;

  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(n_txns, r_begin + rows_per_split);
  const int part_rows = kSlabTile / parts;
  uint32_t cnt = 0;
  for (int base = r_begin; base < r_end; base += kSlabTile) {
    const int nr = min(kSlabTile, r_end - base);
    const uint32_t* src = txns + (size_t)base * W;
    for (int i = threadIdx.x; i < kSlabTile * W; i += kThreads) {
      const int r = i / W;
      s_t[r * P + i % W] = r < nr ? __ldg(src + i) : 0u;
    }
    for (int r = threadIdx.x; r < kSlabTile; r += kThreads)
      s_sign[r] = r < nr ? __ldg(sign + base + r) : 0;
    __syncthreads();
    // rows [r0, r1) of this part, four at a time (rows past nr weigh 0)
    const int r0 = part * part_rows;
    const int r1 = min(r0 + part_rows, nr);
    for (int r = r0; r < r1; r += 4) {
      const int4 g4 = *reinterpret_cast<const int4*>(s_sign + r);
      const int g[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t t[W];
        load_row<W>(s_t, r + q, t);
        uint32_t miss = 0;
#pragma unroll
        for (int w = 0; w < W; ++w) miss |= cw[w] & ~t[w];
        cnt += miss ? 0u : (uint32_t)g[q];
      }
    }
    __syncthreads();                 // the tile is read; restage it
  }
  if (parts > 1) {
    s_part[threadIdx.x] = cnt;
    __syncthreads();
    if (part != 0) return;
    for (int q = 1; q < parts; ++q) cnt += s_part[q * per_block + local];
  }
  if (c < n_cands) {
    if (merge) atomicAdd(out + c, (int)cnt);
    else out[c] = (int)cnt;
  }
}

// The same count for any W, with the words taken kWideChunk at a time: the
// block stages a chunk of its 32 candidates' words in shared memory, each
// thread tests its row's words of that chunk, and bit b of a register keeps
// "candidate b ⊆ this row" across the chunks.  For each candidate b the
// warp's 32 signed matches are then reduced in one __reduce_add_sync and
// lane b keeps candidate b's count.  Used past the register instances
// (W > 8, more than 256 items), so a row never has to fit in registers.
constexpr int kHorzBC = 32;  // candidates per block: one per lane
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

// The register instances (n_words 1..8): parts of a block and slices of
// the slab for a grid of at least two blocks an SM; a memset only where
// slices meet in atomics.
template <int W>
cudaError_t launch_subset_count_w(const uint32_t* cands, int n_cands,
                                  const uint32_t* txns, const int32_t* sign,
                                  int n_txns, int32_t* out,
                                  cudaStream_t stream) {
  const int n_sms = sm_count();
  if (n_sms == 0) return cudaErrorNoDevice;
  const int target = 2 * n_sms;
  int parts = 1;
  while (parts < kWarps && ceil_div(n_cands, kThreads / parts) < target)
    parts *= 2;
  const int bx = ceil_div(n_cands, kThreads / parts);
  int splits = bx < target ? ceil_div(target, bx) : 1;
  const int most = ceil_div(n_txns, kSplitQuantum);
  if (splits > most) splits = most;
  if (splits > 65535) splits = 65535;
  const int per =
      ceil_div(ceil_div(n_txns, splits), kSplitQuantum) * kSplitQuantum;
  splits = ceil_div(n_txns, per);
  const int merge = splits > 1;
  if (merge) {
    cudaError_t err = cudaMemsetAsync(
        out, 0, (size_t)n_cands * sizeof(int32_t), stream);
    if (err != cudaSuccess) return err;
  }
  subset_count_kernel<W><<<dim3(bx, splits), kThreads, 0, stream>>>(
      cands, n_cands, txns, sign, n_txns, parts, per, merge, out);
  return cudaGetLastError();
}

// The chunked instance for any n_words (W > 8; W = 0 too, where every row
// holds the empty candidate), merged by atomics on a zeroed output.
cudaError_t launch_subset_count_wide(const uint32_t* cands, int n_cands,
                                     const uint32_t* txns,
                                     const int32_t* sign, int n_txns,
                                     int n_words, int32_t* out,
                                     cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(
      out, 0, (size_t)n_cands * sizeof(int32_t), stream);
  if (err != cudaSuccess) return err;
  const int bx = ceil_div(n_cands, kHorzBC);
  int splits, per;
  split_axis(n_txns, bx, kThreads, &splits, &per);
  subset_count_wide_kernel<<<dim3(bx, splits), kThreads, 0, stream>>>(
      cands, n_cands, txns, sign, n_txns, n_words, per, out);
  return cudaGetLastError();
}

// Launch the instance for n_words: 1..8 keep a candidate in registers,
// wider rows take the chunked instance.
cudaError_t launch_subset_count(const void* cands, const void* txns,
                                const void* sign, int n_cands, int n_txns,
                                int n_words, void* out, cudaStream_t s) {
  const uint32_t* c = static_cast<const uint32_t*>(cands);
  const uint32_t* t = static_cast<const uint32_t*>(txns);
  const int32_t* g = static_cast<const int32_t*>(sign);
  int32_t* o = static_cast<int32_t*>(out);
  if (n_txns <= 0)                 // an empty slab moves no count
    return cudaMemsetAsync(out, 0, (size_t)n_cands * sizeof(int32_t), s);
  switch (n_words) {
    case 1: return launch_subset_count_w<1>(c, n_cands, t, g, n_txns, o, s);
    case 2: return launch_subset_count_w<2>(c, n_cands, t, g, n_txns, o, s);
    case 3: return launch_subset_count_w<3>(c, n_cands, t, g, n_txns, o, s);
    case 4: return launch_subset_count_w<4>(c, n_cands, t, g, n_txns, o, s);
    case 5: return launch_subset_count_w<5>(c, n_cands, t, g, n_txns, o, s);
    case 6: return launch_subset_count_w<6>(c, n_cands, t, g, n_txns, o, s);
    case 7: return launch_subset_count_w<7>(c, n_cands, t, g, n_txns, o, s);
    case 8: return launch_subset_count_w<8>(c, n_cands, t, g, n_txns, o, s);
    default:
      return launch_subset_count_wide(c, n_cands, t, g, n_txns, n_words, o,
                                      s);
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
