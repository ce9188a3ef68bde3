"""Probe of the write floor of the serving score matrix on the card.

    PYTHONPATH=src python -m repro_torch.probes.store_floor

The rule kernels write a (Qp, R) float32 matrix, (512, 43,694) at the
serving shape: 89 MB whose row pitch, R·4 = 174,776 bytes, is 8-byte
aligned but not 16 (and only 4-byte aligned for odd R).  This probe times
kernels that do nothing but write -inf into that matrix, so it shows how
far the store pattern alone sits from the bytes' bound on this card:

* ``a_tile``  — 4-byte stores, one warp on 32 neighbouring floats of a
  row: a block of 128 threads owns a 64-row × 128-column tile, a thread one
  column (the popcount rule kernel's pattern);
* ``b_tile``  — 16-byte stores: a warp writes each row piece of a 64-row ×
  512-column tile from its first 16-byte boundary, with scalar head and
  tail;
* ``c_tma``   — one-dimensional TMA bulk stores
  (``cp.async.bulk.global.shared::cta``) of each row piece's aligned middle
  from a staged shared-memory tile, scalar head and tail;
* ``a_flat`` and ``b_flat`` — the matrix as one contiguous array, 4- and
  16-byte stores in a grid-stride loop (no row structure);
* ``a_2k`` and ``a_4k`` — 4-byte stores of 64-row tiles whose row pieces
  are 2 and 4 KB: a thread of 128 owns 4 or 8 columns 128 apart, so each
  store of a warp covers 128 contiguous bytes;
* ``fill_``   — ``torch.empty(...).fill_(-inf)``, a reference point.

Each kernel is first checked to write exactly the whole matrix at R of
43,693 / 43,694 / 43,695 (every row alignment).  Times are CUDA-event means
over 20 back-to-back launches, two rounds in opposite orders.  The last
line is JSON.  The library is built into ``repro_torch/_build/``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from repro_torch.kernels._build import BUILD_DIR, NVCC_FLAGS, _nvcc

Q, R = 512, 43694
HBM_BYTES_PER_S = 3.35e12          # H100 SXM at 700 W, NVIDIA's data sheet

SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kRows = 64;          // rows a tile
constexpr int kColsA = 128;        // columns a tile, a_tile
constexpr int kColsB = 512;        // columns a tile, b_tile and c_tma

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__global__ void __launch_bounds__(128) a_tile(float* out, int rows, int cols) {
  const int c = blockIdx.x * kColsA + threadIdx.x, q0 = blockIdx.y * kRows;
  if (c >= cols) return;
  const int q1 = min(rows, q0 + kRows);
  for (int q = q0; q < q1; ++q) out[(size_t)q * cols + c] = neg_inf();
}

// floats [0, n) of one row piece p, 16-byte stores from the first boundary
__device__ __forceinline__ void row_b(float* p, int n, int lane) {
  const int head = min(n, (int)(((16u - ((uintptr_t)p & 15u)) & 15u) >> 2));
  if (lane < head) p[lane] = neg_inf();
  float4* mid = reinterpret_cast<float4*>(p + head);
  const int nv = (n - head) >> 2;
  const float4 v = make_float4(neg_inf(), neg_inf(), neg_inf(), neg_inf());
  for (int i = lane; i < nv; i += 32) mid[i] = v;
  const int tail = n - head - 4 * nv;
  if (lane < tail) p[head + 4 * nv + lane] = neg_inf();
}

__global__ void __launch_bounds__(128) b_tile(float* out, int rows, int cols) {
  const int c0 = blockIdx.x * kColsB, q0 = blockIdx.y * kRows;
  const int n = min(kColsB, cols - c0), q1 = min(rows, q0 + kRows);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int q = q0 + warp; q < q1; q += 4)
    row_b(out + (size_t)q * cols + c0, n, lane);
}

// the staged tile: one row of kColsB floats is all a bulk store reads, so
// the probe stages one row and every row's middle is copied from it
__global__ void __launch_bounds__(128) c_tma(float* out, int rows, int cols) {
  __shared__ __align__(128) float s_row[kColsB];
  for (int i = threadIdx.x; i < kColsB; i += 128) s_row[i] = neg_inf();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int c0 = blockIdx.x * kColsB, q0 = blockIdx.y * kRows;
  const int n = min(kColsB, cols - c0), q1 = min(rows, q0 + kRows);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int q = q0 + warp; q < q1; q += 4) {
    float* p = out + (size_t)q * cols + c0;
    const int head = min(n, (int)(((16u - ((uintptr_t)p & 15u)) & 15u) >> 2));
    const int nv = (n - head) >> 2, tail = n - head - 4 * nv;
    if (lane < head) p[lane] = neg_inf();
    if (lane < tail) p[head + 4 * nv + lane] = neg_inf();
    if (lane == 0 && nv > 0) {
      const uint32_t src =
          static_cast<uint32_t>(__cvta_generic_to_shared(s_row));
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
          ::"l"(p + head), "r"(src), "r"(nv * 16) : "memory");
    }
  }
  if (lane == 0) {
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// KC columns a thread, 128 apart: a tile's row pieces are KC·512 bytes
template <int KC>
__global__ void __launch_bounds__(128) a_wide(float* out, int rows, int cols) {
  const int c0 = blockIdx.x * 128 * KC + threadIdx.x, q0 = blockIdx.y * kRows;
  const int q1 = min(rows, q0 + kRows);
  for (int q = q0; q < q1; ++q) {
#pragma unroll
    for (int j = 0; j < KC; ++j)
      if (c0 + 128 * j < cols) out[(size_t)q * cols + c0 + 128 * j] = neg_inf();
  }
}

__global__ void a_flat(float* out, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = neg_inf();
}

__global__ void b_flat(float4* out, long long n4) {
  const float4 v = make_float4(neg_inf(), neg_inf(), neg_inf(), neg_inf());
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = v;
}

extern "C" int store(int which, void* out, int rows, int cols, int n_sms,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const long long n = (long long)rows * cols;
  switch (which) {
    case 0:
      a_tile<<<dim3((cols + kColsA - 1) / kColsA, (rows + kRows - 1) / kRows),
               128, 0, s>>>(o, rows, cols);
      break;
    case 1:
      b_tile<<<dim3((cols + kColsB - 1) / kColsB, (rows + kRows - 1) / kRows),
               128, 0, s>>>(o, rows, cols);
      break;
    case 2:
      c_tma<<<dim3((cols + kColsB - 1) / kColsB, (rows + kRows - 1) / kRows),
              128, 0, s>>>(o, rows, cols);
      break;
    case 3:
      a_flat<<<8 * n_sms, 256, 0, s>>>(o, n);
      break;
    case 4:    // the whole matrix as float4: n must be a multiple of 4
      b_flat<<<8 * n_sms, 256, 0, s>>>(reinterpret_cast<float4*>(o), n / 4);
      break;
    case 5:
      a_wide<4><<<dim3((cols + 511) / 512, (rows + kRows - 1) / kRows), 128,
                  0, s>>>(o, rows, cols);
      break;
    default:
      a_wide<8><<<dim3((cols + 1023) / 1024, (rows + kRows - 1) / kRows),
                  128, 0, s>>>(o, rows, cols);
      break;
  }
  return cudaGetLastError();
}
"""

KERNELS = ("a_tile", "b_tile", "c_tma", "a_flat", "b_flat", "a_2k", "a_4k")


def _build() -> tuple[ctypes.CDLL, str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, lib = BUILD_DIR / "probe_store.cu", BUILD_DIR / "libprobe_store.so"
    src.write_text(SRC)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stderr)
        raise SystemExit("the probe does not compile")
    so = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    so.store.argtypes = (I, P, I, I, I, P)
    return so, proc.stderr


def _time(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("store_floor: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    so, ptxas = _build()
    print(ptxas)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def launch(which, out):
        err = so.store(which, out.data_ptr(), out.shape[0], out.shape[1],
                       n_sms, stream())
        if err:
            raise RuntimeError(f"{KERNELS[which]}: cudaError_t {err}")

    exact = {}
    for cols in (R - 1, R, R + 1):
        for which, name in enumerate(KERNELS):
            # four floats of padding on each side show a store past either
            # end; the row kernels also start one float off a 16-byte
            # boundary, so their rows take every alignment
            lead = 4 if name == "b_flat" else 5
            buf = torch.zeros(Q * cols + 8, dtype=torch.float32,
                              device="cuda")
            out = buf[lead:lead + Q * cols].view(Q, cols)
            launch(which, out)
            torch.cuda.synchronize()
            exact[f"{name}@{cols}"] = (
                bool(torch.isneginf(out).all())
                and not buf[:lead].any() and not buf[lead + Q * cols:].any())
    print("exact:", exact)
    if not all(exact.values()):
        raise SystemExit("a store kernel wrote the wrong bytes")

    out = torch.empty((Q, R), dtype=torch.float32, device="cuda")
    bound_ms = 1e3 * out.numel() * 4 / HBM_BYTES_PER_S
    runs = {name: [] for name in (*KERNELS, "fill_")}
    order = list(enumerate((*KERNELS, "fill_")))
    for rnd in range(2):
        for which, name in (order if rnd == 0 else order[::-1]):
            if name == "fill_":
                fn = lambda: torch.empty((Q, R), dtype=torch.float32,  # noqa: E731
                                         device="cuda").fill_(float("-inf"))
            else:
                fn = lambda w=which: launch(w, out)  # noqa: E731
            runs[name].append(_time(fn))
    for name, ms in runs.items():
        print(f"store {name}: {ms[0]:.4f} / {ms[1]:.4f} ms, "
              f"{out.numel() * 4 / min(ms) / 1e6:.0f} GB/s, "
              f"{min(ms) / bound_ms:.2f}x the bound {bound_ms:.4f} ms")
    print(json.dumps({"device": smi, "shape": [Q, R], "bound_ms": bound_ms,
                      "exact": exact, "ms": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
