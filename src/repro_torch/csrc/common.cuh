// Launch geometry shared by the port's CUDA sources (counting.cu,
// delta_count.cu, rule_match.cu).
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

}  // namespace
