// Hand-written Hopper (sm_90a) kernels for Apriori candidate generation:
// the join of a level and the prune of its candidates.
//
// Replaces no TPU kernel: both packages generated candidates on the host,
// in numpy (core/candidates.py: _join_pairs_prefix and _prune).  Added
// because that host code set the mining cells' mine() time while the card
// sat idle (PERF.md §5): join and prune were 59% and 77% of a mine, each a
// chain of numpy passes over a few hundred KB, paid in per-call overhead.
//
// What bounds it: launches and one host read a call, not bytes or
// operations.  The largest join of the mining cells is 8,855 rows × 4 words
// into 33,649 candidates, about 1.1 M binary searches over a 142 KB level
// that stays in L2: the three launches take about 0.05 ms of the card, its
// bytes 0.0004 ms at 3.35 TB/s.  A call costs its upload, the launches, one
// read of the output count and one copy home (PERF.md, rows 9 and 10).
//
// The level L (n rows × W words, unsigned, high word most significant) is
// in canonical order: strictly increasing as a multiword integer.
//
// * Join.  A candidate is a | b for rows a = P ∪ {h_a}, b = P ∪ {h_b} of L,
//   h_a < h_b their highest items.  Below its top item h_b it holds exactly
//   a's items, so in canonical order the candidates sort by (h_b, rank of a
//   in L), and each pair (h, i) gives at most one: the candidate exists iff
//   h > h_i and (L_i − {h_i}) ∪ {h} is a row of L.  So the join is a grid
//   of n_flags = 32W·n match flags f = h·n + i, row-major: a binary search
//   of L for each, an exclusive scan of the flags, and a write at each
//   flag's rank — the canonical order with no grouping and no sort.  left
//   is i and right the row found, as the numpy join yields them.
// * Prune.  A candidate is kept iff every subset that drops one of its
//   items is a row of L (L sorted non-decreasing): a binary search a subset,
//   then the same scan and an order-keeping write.
//
// Each entry point is called twice around the host's read of the output
// count, so that the wrapper can size the output; the kernels allocate
// nothing:
//
//   with no output: the count pass (match flags summed by block; rows of L
//       out of order counted beside them), then one block scans the block
//       counts into offsets and writes the total and the out-of-order count
//       to scratch[0..1];
//   with an output: the write pass, the same flags again, ranked inside
//       the block by ballot, written at the block's offset.
//
// The flags are not kept between the calls: recomputing them costs less
// than a scratch of n_flags ints, and leaves the scratch at 2 + 2·kScanBlocks
// ints whatever the level's size.  A block owns `rounds` consecutive tiles
// of kThreads flags, so at most kScanBlocks blocks cover any grid.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "common.cuh"

namespace {

// blocks of a pass at most, and the threads of the one block that scans them
constexpr int kScanBlocks = 1024;
static_assert(kScanBlocks % 32 == 0 && kScanBlocks / 32 <= 32,
              "the scan's warp totals are scanned by one warp");

// scratch (ints): [0] the output count, [1] rows of L out of order,
// [2, 2 + kScanBlocks) block counts, scanned into offsets in place,
// [2 + kScanBlocks, 2 + 2·kScanBlocks) block out-of-order counts
constexpr int kOffsets = 2;
constexpr int kFaults = 2 + kScanBlocks;

// Every row is read through the read-only path (__ldg): the level and the
// candidates stay unchanged for a launch, and the binary searches of a
// warp revisit the same rows of L.  The row width W reaches these helpers
// as a constant where the Ops below are instances for W = 1 to 8, so their
// loops unroll and a query's words stay in registers.

// The highest item of a row, or -1 for the empty row.
__device__ __forceinline__ int top_item(const uint32_t* a, int W) {
#pragma unroll
  for (int w = W - 1; w >= 0; --w) {
    const uint32_t x = __ldg(a + w);
    if (x) return 32 * w + 31 - __clz(x);
  }
  return -1;
}

// Word w of the query: row a without item `drop` and with item `add`
// (either -1: none).
__device__ __forceinline__ uint32_t query_word(const uint32_t* a, int w,
                                               int drop, int add) {
  uint32_t q = __ldg(a + w);
  if (drop >= 0 && (drop >> 5) == w) q &= ~(1u << (drop & 31));
  if (add >= 0 && (add >> 5) == w) q |= 1u << (add & 31);
  return q;
}

// -1, 0 or 1 as `row` is below, equal to or above the query, as unsigned
// multiword integers, high word first.
__device__ __forceinline__ int compare(const uint32_t* row, const uint32_t* a,
                                       int W, int drop, int add) {
#pragma unroll
  for (int w = W - 1; w >= 0; --w) {
    const uint32_t l = __ldg(row + w), q = query_word(a, w, drop, add);
    if (l != q) return l < q ? -1 : 1;
  }
  return 0;
}

// A row of L (sorted non-decreasing) equal to the query, or -1.
__device__ __forceinline__ int find_row(const uint32_t* L, int n, int W,
                                        const uint32_t* a, int drop,
                                        int add) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    const int c = compare(L + (size_t)mid * W, a, W, drop, add);
    if (c == 0) return mid;
    if (c < 0) lo = mid + 1; else hi = mid;
  }
  return -1;
}

// The join's flags: flag f = h·n + i holds the row that joins row i at
// item h (the candidate's top item), or -1.  KW: the row width W where it
// is 1 to 8, else 0 and W = n_words.
template <int KW>
struct JoinOp {
  const uint32_t* L;
  int n, n_words;
  uint32_t* cands;       // write pass: (count, W)
  long long* left;       // write pass, both optional: (count,)
  long long* right;

  __device__ __forceinline__ int width() const {
    return KW > 0 ? KW : n_words;
  }
  __device__ int probe(int f) const {
    const int W = width();
    const int h = f / n, i = f - h * n;
    const uint32_t* a = L + (size_t)i * W;
    const int top = top_item(a, W);
    return h > top ? find_row(L, n, W, a, top, h) : -1;
  }
  // rows i and i + 1 not strictly increasing
  __device__ bool fault(int i) const {
    const int W = width();
    return compare(L + (size_t)i * W, L + (size_t)(i + 1) * W, W, -1, -1)
           >= 0;
  }
  __device__ void emit(long long pos, int f, int r) const {
    const int W = width();
    const int h = f / n, i = f - h * n;
    const uint32_t* a = L + (size_t)i * W;
    uint32_t* out = cands + pos * W;
#pragma unroll
    for (int w = 0; w < W; ++w) out[w] = query_word(a, w, -1, h);
    if (left != nullptr) {
      left[pos] = i;
      right[pos] = r;
    }
  }
};

// The prune's flags: flag j is 0 where every subset of candidate j that
// drops one item is a row of L, else -1.
template <int KW>
struct PruneOp {
  const uint32_t* C;
  const uint32_t* L;
  int n, n_words;
  uint32_t* out;         // write pass: (count, W)

  __device__ __forceinline__ int width() const {
    return KW > 0 ? KW : n_words;
  }
  __device__ int probe(int j) const {
    const int W = width();
    const uint32_t* c = C + (size_t)j * W;
#pragma unroll
    for (int w = 0; w < W; ++w)
      for (uint32_t bits = __ldg(c + w); bits; bits &= bits - 1)
        if (find_row(L, n, W, c, 32 * w + __ffs(bits) - 1, -1) < 0)
          return -1;
    return 0;
  }
  // rows i and i + 1 decreasing (equal rows do no harm to a membership test)
  __device__ bool fault(int i) const {
    const int W = width();
    return compare(L + (size_t)i * W, L + (size_t)(i + 1) * W, W, -1, -1)
           > 0;
  }
  __device__ void emit(long long pos, int j, int) const {
    const int W = width();
#pragma unroll
    for (int w = 0; w < W; ++w) out[pos * W + w] = __ldg(C + (size_t)j * W + w);
  }
};

// Pass geometry: tiles of kThreads flags, at most kScanBlocks blocks of
// `rounds` consecutive tiles each.
struct Geometry {
  int blocks, rounds;
};

Geometry geometry(int extent) {
  const int tiles = extent > 0 ? ceil_div(extent, kThreads) : 1;
  const int blocks = tiles < kScanBlocks ? tiles : kScanBlocks;
  return {blocks, ceil_div(tiles, blocks)};
}

// Count pass: each block's matches among flags [0, n_flags) and rows of L
// out of order among [0, n_checks), into its scratch slots.
template <class Op>
__global__ void __launch_bounds__(kThreads)
count_kernel(Op op, int n_flags, int n_checks, int rounds,
             int* __restrict__ scratch) {
  const long long first = (long long)blockIdx.x * rounds * kThreads;
  int count = 0, faults = 0;
  for (int r = 0; r < rounds; ++r) {
    const long long f = first + (long long)r * kThreads + threadIdx.x;
    const bool hit = f < n_flags && op.probe((int)f) >= 0;
    const bool bad = f < n_checks && op.fault((int)f);
    count += __syncthreads_count(hit);
    faults += __syncthreads_count(bad);
  }
  if (threadIdx.x == 0) {
    scratch[kOffsets + blockIdx.x] = count;
    scratch[kFaults + blockIdx.x] = faults;
  }
}

// One block of kScanBlocks threads: the block counts into exclusive
// offsets, the total into scratch[0], the faults' sum into scratch[1].
__global__ void __launch_bounds__(kScanBlocks)
scan_kernel(int n_blocks, int* __restrict__ scratch) {
  __shared__ int s_warp[kScanBlocks / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int v = t < n_blocks ? scratch[kOffsets + t] : 0;
  const int bad = t < n_blocks ? scratch[kFaults + t] : 0;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int y = lane < kScanBlocks / 32 ? s_warp[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int z = __shfl_up_sync(0xffffffffu, y, d);
      if (lane >= d) y += z;
    }
    if (lane < kScanBlocks / 32) s_warp[lane] = y;
  }
  __syncthreads();
  const int inclusive = x + (warp > 0 ? s_warp[warp - 1] : 0);
  if (t < n_blocks) scratch[kOffsets + t] = inclusive - v;
  const int faults = __syncthreads_count(bad != 0);
  if (t == kScanBlocks - 1) scratch[0] = inclusive;
  if (t == 0) scratch[1] = faults;
}

// Write pass: the count pass's flags again, each match written at its
// block's offset plus its rank in the block, so the output keeps the flags'
// order.
template <class Op>
__global__ void __launch_bounds__(kThreads)
write_kernel(Op op, int n_flags, int rounds,
             const int* __restrict__ scratch) {
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long first = (long long)blockIdx.x * rounds * kThreads;
  long long base = scratch[kOffsets + blockIdx.x];
  for (int r = 0; r < rounds; ++r) {
    const long long f = first + (long long)r * kThreads + threadIdx.x;
    const int found = f < n_flags ? op.probe((int)f) : -1;
    const unsigned ballot = __ballot_sync(0xffffffffu, found >= 0);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_warp[w];
      if (w < warp) before += c;
      total += c;
    }
    if (found >= 0)
      op.emit(base + before + __popc(ballot & ((1u << lane) - 1u)), (int)f,
              found);
    base += total;
    __syncthreads();
  }
}

constexpr long long kMaxFlags = 0x7fffffffLL;

template <class Op>
int launch_count(const Op& op, int n_flags, int n_checks, void* scratch,
                 cudaStream_t s) {
  const Geometry g = geometry(n_flags > n_checks ? n_flags : n_checks);
  int* sc = static_cast<int*>(scratch);
  count_kernel<Op><<<g.blocks, kThreads, 0, s>>>(op, n_flags, n_checks,
                                                 g.rounds, sc);
  scan_kernel<<<1, kScanBlocks, 0, s>>>(g.blocks, sc);
  return (int)cudaGetLastError();
}

template <class Op>
int launch_write(const Op& op, int n_flags, int n_checks, void* scratch,
                 cudaStream_t s) {
  const Geometry g = geometry(n_flags > n_checks ? n_flags : n_checks);
  write_kernel<Op><<<g.blocks, kThreads, 0, s>>>(
      op, n_flags, g.rounds, static_cast<const int*>(scratch));
  return (int)cudaGetLastError();
}

// `launch` (launch_count or launch_write) on the instance of Op for the
// level's width: W = 1 to 8 compiled, else read at run time.
template <template <int> class Op, class Launch, class... Fields>
int by_width(int n_words, Launch launch, Fields... fields) {
  switch (n_words) {
    case 1: return launch(Op<1>{fields...});
    case 2: return launch(Op<2>{fields...});
    case 3: return launch(Op<3>{fields...});
    case 4: return launch(Op<4>{fields...});
    case 5: return launch(Op<5>{fields...});
    case 6: return launch(Op<6>{fields...});
    case 7: return launch(Op<7>{fields...});
    case 8: return launch(Op<8>{fields...});
    default: return launch(Op<0>{fields...});
  }
}

bool join_shape_ok(int n, int n_words) {
  return n >= 0 && n_words >= 1 && 32LL * n_words * n <= kMaxFlags;
}

bool prune_shape_ok(int n_cands, int n, int n_words) {
  return n_cands >= 0 && n >= 0 && n_words >= 1;
}

}  // namespace

extern "C" {

// A call with no output (cands null) is the count pass; with one, the write
// pass into it (left and right optional, both or neither).
int candidate_join(const void* level, int n, int n_words, void* scratch,
                   void* cands, void* left, void* right, void* stream) {
  if (!join_shape_ok(n, n_words) || (left == nullptr) != (right == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const int n_flags = 32 * n_words * n;
  return by_width<JoinOp>(
      n_words,
      [&](const auto& op) {
        return cands == nullptr
                   ? launch_count(op, n_flags, n - 1, scratch, s)
                   : launch_write(op, n_flags, n - 1, scratch, s);
      },
      static_cast<const uint32_t*>(level), n, n_words,
      static_cast<uint32_t*>(cands), static_cast<long long*>(left),
      static_cast<long long*>(right));
}

// A call with no output (out null) is the count pass; with one, the write
// pass into it.
int candidate_prune(const void* cands, int n_cands, const void* level, int n,
                    int n_words, void* scratch, void* out, void* stream) {
  if (!prune_shape_ok(n_cands, n, n_words)) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return by_width<PruneOp>(
      n_words,
      [&](const auto& op) {
        return out == nullptr
                   ? launch_count(op, n_cands, n - 1, scratch, s)
                   : launch_write(op, n_cands, n - 1, scratch, s);
      },
      static_cast<const uint32_t*>(cands),
      static_cast<const uint32_t*>(level), n, n_words,
      static_cast<uint32_t*>(out));
}

}  // extern "C"
