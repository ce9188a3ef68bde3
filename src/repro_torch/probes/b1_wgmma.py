"""Probe of Hopper's single-bit tensor-core product, ``wgmma`` ``.b1``.

    PYTHONPATH=src python -m repro_torch.probes.b1_wgmma

On a machine with an H100 and ``nvcc`` it compiles a small library for
``sm_90a`` and prints, as JSON on its last line:

* whether ``wgmma.mma_async.sync.aligned.m64n128k256.s32.b1.b1.and.popc``
  assembles, and the spelling CUTLASS's headers use for it;
* whether it is exact: its (64, 128) products of one warpgroup, from two
  no-swizzle K-major shared-memory tiles, against ``popc(a & b)`` summed
  over the words of random rows, at K = 256 and 512 bits;
* its rate, from a long loop of the instruction on every SM, beside the
  same loop of the int8 ``m64n128k32`` product that reads the same 32 bytes
  of K a row (both as instructions/s and as ops/s, where a b1 op is one
  bit's AND and add);
* the SASS opcodes the two become (``cuobjdump -sass``).

The library is built into ``repro_torch/_build/``.
"""

from __future__ import annotations

import ctypes
import glob
import json
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

from repro_torch.kernels._build import BUILD_DIR, NVCC_FLAGS, _nvcc

_REGS = ", ".join(f"%{i}" for i in range(64))
_OUTS = ", ".join(f'"+r"(d[{i}])' for i in range(64))

SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

#define MMA(OP)                                                              \
  __device__ __forceinline__ void mma_##OP(int (&d)[64], uint64_t da,        \
                                           uint64_t db, int scale_d) {       \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                \
                 "wgmma.mma_async.sync.aligned." INSN_##OP " "               \
                 "{@REGS@}, %64, %65, p;\n}\n"                               \
                 : @OUTS@                                                    \
                 : "l"(da), "l"(db), "r"(scale_d));                          \
  }
#define INSN_b1 "m64n128k256.s32.b1.b1.and.popc"
#define INSN_s8 "m64n128k32.s32.s8.s8"
MMA(b1)
MMA(s8)

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// word w of row r of a tile of R rows: 16-byte row pieces column by column
__device__ __forceinline__ int word_at(int R, int r, int w) {
  return (w / 4) * 4 * R + 4 * r + (w % 4);
}

// one warpgroup: d = A·Bᵀ as AND-popcount over kw words (a multiple of 8)
__global__ void check_kernel(const uint32_t* a, const uint32_t* b, int* out,
                             int kw) {
  __shared__ __align__(128) uint32_t sa[64 * 32];
  __shared__ __align__(128) uint32_t sb[128 * 32];
  const int tid = threadIdx.x;
  for (int i = tid; i < 64 * kw; i += 128)
    sa[word_at(64, i / kw, i % kw)] = a[i];
  for (int i = tid; i < 128 * kw; i += 128)
    sb[word_at(128, i / kw, i % kw)] = b[i];
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  int d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;
  fence_acc(d);
  fence();
  for (int k = 0; k < kw / 8; ++k)       // 8 words = 256 bits a step
    mma_b1(d, smem_desc(sa + k * 2 * 4 * 64, 64 * 16, 128),
           smem_desc(sb + k * 2 * 4 * 128, 128 * 16, 128), k > 0);
  commit();
  wait0();
  fence_acc(d);
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int row = 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    out[row * 128 + col] = d[i];
  }
}

// every warpgroup of every block: iters × 16 products on its own
// accumulators from one staged pair of tiles (32 bytes of K a row)
template <bool kB1>
__global__ void __launch_bounds__(256) rate_kernel(int* out, int iters) {
  __shared__ __align__(128) uint32_t sa[2][64 * 8];
  __shared__ __align__(128) uint32_t sb[128 * 8];
  const int tid = threadIdx.x, wg = tid / 128;
  for (int i = tid; i < 2 * 64 * 8; i += 256)
    sa[i / 512][i % 512] = 0x9E3779B9u * (i + 1 + blockIdx.x);
  for (int i = tid; i < 128 * 8; i += 256) sb[i] = 0x85EBCA6Bu * (i + 7);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint64_t da = smem_desc(sa[wg], 64 * 16, 128);
  const uint64_t db = smem_desc(sb, 128 * 16, 128);
  int d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;
  for (int it = 0; it < iters; ++it) {
    fence_acc(d);
    fence();
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (kB1) mma_b1(d, da, db, 1);
      else mma_s8(d, da, db, 1);
    }
    commit();
    wait0();
    fence_acc(d);
  }
  int s = 0;
#pragma unroll
  for (int i = 0; i < 64; ++i) s += d[i];
  atomicAdd(out, s);
}

extern "C" {
int b1_check(const void* a, const void* b, void* out, int kw, void* stream) {
  check_kernel<<<1, 128, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (int*)out, kw);
  return cudaGetLastError();
}
int rate(void* out, int iters, int blocks, int b1, void* stream) {
  if (b1)
    rate_kernel<true><<<blocks, 256, 0, (cudaStream_t)stream>>>((int*)out,
                                                                 iters);
  else
    rate_kernel<false><<<blocks, 256, 0, (cudaStream_t)stream>>>((int*)out,
                                                                  iters);
  return cudaGetLastError();
}
}
""".replace("@REGS@", _REGS).replace("@OUTS@", _OUTS)


def _build() -> tuple[ctypes.CDLL, str, str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, lib = BUILD_DIR / "probe_b1.cu", BUILD_DIR / "libprobe_b1.so"
    src.write_text(SRC)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stderr)
        raise SystemExit("the probe does not assemble")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    so = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    so.b1_check.argtypes = (P, P, P, I, P)
    so.rate.argtypes = (P, I, I, I, P)
    return so, proc.stderr, sass


def _cutlass_spelling() -> list[str]:
    found = []
    for path in sorted(glob.glob(
            "/usr/local/cutlass/include/cute/arch/mma_sm90_gmma*.hpp")):
        with open(path) as f:
            for line in f:
                if "m64n128k256" in line and "b1" in line:
                    found.append(line.strip())
    return found[:4]


def _opcodes(sass: str) -> dict[str, list[str]]:
    ops, fn = {}, None
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            fn = head.group(1)
            ops[fn] = []
            continue
        m = re.search(r"\b([A-Z]*MMA[.\w]*)", line)
        if fn and m and m.group(1) not in ops[fn]:
            ops[fn].append(m.group(1))
    return ops


def main() -> int:
    if not torch.cuda.is_available():
        print("b1_wgmma: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    spelling = _cutlass_spelling()
    print("cutlass:", *spelling, sep="\n  ")
    so, ptxas, sass = _build()
    print(ptxas)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    rng = np.random.default_rng(0)
    exact = {}
    for kw in (8, 16):
        a = rng.integers(0, 2**32, (64, kw), dtype=np.uint32)
        b = rng.integers(0, 2**32, (128, kw), dtype=np.uint32)
        a[3] = 0
        b[5] = 0xFFFFFFFF
        da = torch.from_numpy(a.view(np.int32)).cuda()
        db = torch.from_numpy(b.view(np.int32)).cuda()
        out = torch.full((64, 128), -1, dtype=torch.int32, device="cuda")
        err = so.b1_check(da.data_ptr(), db.data_ptr(), out.data_ptr(), kw,
                          stream())
        torch.cuda.synchronize()
        abits = np.unpackbits(a.view(np.uint8), axis=1).astype(np.int64)
        bbits = np.unpackbits(b.view(np.uint8), axis=1).astype(np.int64)
        want = abits @ bbits.T
        got = out.cpu().numpy()
        exact[kw * 32] = {"err": err, "max_abs_diff":
                          int(np.abs(got - want).max())}
    print("exact:", exact)

    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 4 * n_sms, 4000
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    rates = {}
    for _ in range(2):                       # b1, int8, b1, int8
        for name, b1, k in (("b1", 1, 256), ("s8", 0, 32)):
            so.rate(sink.data_ptr(), 10, blocks, b1, stream())
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            err = so.rate(sink.data_ptr(), iters, blocks, b1, stream())
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
            insns = blocks * 2 * iters * 16
            rates.setdefault(name, []).append({
                "err": err, "ms": ms, "insns_per_s": insns / ms * 1e3,
                "tops": insns * 2 * 64 * 128 * k / ms / 1e9})
    for name, runs in rates.items():
        for r in runs:
            print(f"rate {name}: {r}")
    ops = _opcodes(sass)
    for fn, o in ops.items():
        print(f"sass {fn}: {o}")
    print(json.dumps({"device": smi, "assembles": True, "exact": exact,
                      "rates": rates, "sass": ops, "cutlass": spelling}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
