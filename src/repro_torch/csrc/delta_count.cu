// Hand-written Hopper (sm_90a) kernels for streaming delta counting.
//
// A window update adds and evicts transactions; the build_slab wrapper
// (kernels/delta_count.py) stacks both into one (T, W) slab with an int32
// sign per row (+1 added, −1 evicted, 0 padding), and each tracked
// candidate's count moves by
//
//     delta[i] = Σ_j sign[j] · [cand[i] ⊆ slab[j]].
//
// Both entry points run the counting kernels of common.cuh with the sign as
// a row weight:
//
// * delta_count         replaces delta_count.py:_delta_count_kernel: the
//                       popcount-AND subset test, subset_count_kernel<W,
//                       true>; a warp adds the signs of its 32 rows that
//                       contain candidate b with one __reduce_add_sync.
// * delta_count_matmul  replaces delta_count.py:_delta_count_matmul_kernel:
//                       the bit-plane form, overlap == width weighted by the
//                       sign in the reduction, overlap_count_kernel<int32_t>.
//
// The TPU kernels revisit one (BC,) accumulator along a sequential slab grid
// axis; here the slab is split across blocks (gridDim.y) and the slices meet
// in one int32 atomicAdd per candidate and block.  Integer sums do not depend
// on order, so every delta stays exact.  Sign-0 padding rows contribute 0,
// so no empty-candidate correction is needed (delta_count.py:16-20).
//
// Bound on the H100 at the streaming shape (about 26k tracked candidates
// against a 512-row slab): the popcount form's integer operations,
// C·T·(3W+1); the matmul form's 2·C·T·32W multiply-adds against the int8
// tensor-core rate, which __dp4a on the CUDA cores does not reach.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "common.cuh"

extern "C" {

int delta_count(const void* cands, const void* txns, const void* sign,
                int n_cands, int n_txns, int n_words, void* out,
                void* stream) {
  return launch_subset_count<true>(cands, txns, sign, n_cands, n_txns,
                                   n_words, out,
                                   static_cast<cudaStream_t>(stream));
}

int delta_count_matmul(const void* a, const void* width, const void* b,
                       const void* sign, int m_rows, int n_rows, int k4,
                       void* out, void* stream) {
  return launch_overlap_count<int32_t>(a, width, b, sign, m_rows, n_rows, k4,
                                       out, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
