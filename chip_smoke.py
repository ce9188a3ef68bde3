#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py     # about two minutes on an H100, one of them
                              # spent generating the data on the host

Phases, each printing its own lines; any failure raises and the process exits
non-zero without printing a result:

1. device   — the card's name and count, and ``nvidia-smi``'s name and power
              limit;
2. build    — every CUDA source under ``src/repro_torch/csrc`` compiled by
              ``nvcc`` for sm_90a, one process each, all started together;
3. kernels  — each hand-written kernel against its plain PyTorch version on
              the card at small ragged shapes: exact equality (integer counts);
4. main     — ``mine()`` on the paper's speed-up dataset c20d200k (200,000
              transactions, 192 items, average width 20), min_sup 0.125,
              optimized_vfpc, once with each counting family on the card; each
              family's kernel launch count is set to 0 just before its run and
              read just after.  All four must give byte-identical levels, equal
              to the port's CPU run with the plain vertical version, and the
              port must equal the sequential oracle on a small input;
5. timing   — each kernel at the main path's largest phase shape: exact
              equality with its plain version, then CUDA-event times of the
              kernel, the plain version and (matmul forms) ``torch._int_mm``
              plus compare-and-sum, beside the least time the card could take.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.core import MapReduceRuntime, mine, sequential_apriori  # noqa: E402
from repro_torch.core.bitset import (pack_itemsets, to_device_words,  # noqa: E402
                                     tpopcount_rows, tunpack_bits,
                                     vertical_pack)
from repro_torch.data import dataset_by_name  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.vertical_count import vertical_membership  # noqa: E402

DATASET, MIN_SUP, ALGORITHM = "c20d200k", 0.125, "optimized_vfpc"

# NVIDIA H100 SXM peaks at the full 700 W power limit (NVIDIA's data sheet,
# dense rates): 3.35 TB/s of HBM3 and 1,979 TOP/s of int8 tensor cores.  The
# popcount kernels do 32-bit integer work on the CUDA cores, for which the
# data sheet lists no rate; their bound uses its CUDA-core float32 rate,
# 67 TFLOP/s, which is at least the integer rate, so the bound stays a bound.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
CUDA_CORE_OPS_PER_S = 67e12

# kernel name → the runtime family that reaches it, and the TPU kernel it replaces
FAMILY = {"vertical_count": "vertical", "support_count": "jnp",
          "support_count_matmul": "matmul",
          "vertical_count_matmul": "vertical_matmul"}
REPLACES = {
    "support_count": "src/repro/kernels/support_count.py:36",
    "support_count_matmul": "src/repro/kernels/support_count.py:129",
    "vertical_count": "src/repro/kernels/vertical_count.py:43",
    "vertical_count_matmul": "src/repro/kernels/vertical_count.py:190",
}
SOURCE = "src/repro_torch/csrc/counting.cu"


def phase_device() -> str:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {name} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda}")
    print(smi)
    return name


def phase_build() -> None:
    t0 = time.perf_counter()
    libs = kernels.build_all()
    print(f"build: {time.perf_counter() - t0:.1f}s "
          f"({', '.join(str(p.name) for p in libs.values())})")
    for log in kernels._build.BUILD_LOGS.values():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")


def _random_vertical(rng, n_items, n, kmax, C):
    db = pack_itemsets(
        [sorted(rng.choice(n_items, rng.integers(0, 12), replace=False))
         for _ in range(n)], n_items)
    idx = np.full((C, kmax), n_items, np.int32)
    for i in range(C):
        k = rng.integers(0, kmax + 1)
        idx[i, :k] = rng.choice(n_items, k, replace=False)
    idx[C // 2, :] = n_items          # all-sentinel slots: the empty set
    idx[1, 1] = idx[1, 0]             # a duplicate slot
    return vertical_pack(db, n_items), idx


def kernel_cases(device):
    """Small ragged inputs for each kernel: W > 1, ragged tails, empty
    candidates, duplicate and sentinel slots."""
    rng = np.random.default_rng(0)
    horizontal = []
    for C, T, W in ((1, 1, 1), (17, 33, 2), (300, 700, 8), (1000, 4099, 6)):
        c = rng.integers(0, 2 ** 32, (C, W), dtype=np.uint32)
        t = rng.integers(0, 2 ** 32, (T, W), dtype=np.uint32)
        c[0] = 0
        c[-1] &= t[0]                 # contained in at least one row
        horizontal.append((to_device_words(c, device),
                           to_device_words(t, device)))
    vertical = []
    for n_items, n, kmax, C in ((37, 101, 5, 23), (192, 5003, 4, 777)):
        vdb, idx = _random_vertical(rng, n_items, n, kmax, C)
        vertical.append((to_device_words(vdb, device),
                         torch.from_numpy(idx).to(device)))
    return {"support_count": horizontal, "support_count_matmul": horizontal,
            "vertical_count": vertical, "vertical_count_matmul": vertical}


def _max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {a.shape} vs {b.shape}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
        if a.numel() else 0


def phase_kernels(device) -> None:
    for name, cases in kernel_cases(device).items():
        wrapper, plain = kernels.KERNELS[name]
        worst = 0
        for args in cases:
            got = wrapper(*args)
            torch.cuda.synchronize()
            worst = max(worst, _max_abs_diff(got, plain(*args)))
        print(f"kernel {name}: {len(cases)} ragged cases, max|diff|={worst}")
        if worst:
            raise AssertionError(f"{name} disagrees with its plain version")


def _levels_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        np.array_equal(a[k][0], b[k][0]) and np.array_equal(a[k][1], b[k][1])
        for k in a)


def phase_main():
    """Drive the main path with each family; return the launches each
    kernel made, the database and the largest phase's padded candidates."""
    t0 = time.perf_counter()
    txns, n_items = dataset_by_name(DATASET, seed=0)
    db = pack_itemsets(txns, n_items)
    print(f"data: {DATASET} n_txns={db.shape[0]} "
          f"n_items={n_items} generated in {time.perf_counter() - t0:.1f}s")

    largest = {}
    launches, results = {}, {}
    for name, family in FAMILY.items():
        rt = MapReduceRuntime(impl=family, device="cuda")
        dispatch = rt.phase_count_async

        def record(db_dev, cands, *a, _dispatch=dispatch, **kw):
            if cands.shape[0] > largest.get("cands", np.zeros((0,))).shape[0]:
                largest["cands"] = cands.copy()
            return _dispatch(db_dev, cands, *a, **kw)
        rt.phase_count_async = record

        torch.cuda.synchronize()
        kernels.reset_launches()
        t1 = time.perf_counter()
        res = mine(db_masks=db, n_items=n_items, min_sup=MIN_SUP,
                   algorithm=ALGORITHM, runtime=rt)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        counts = dict(kernels.LAUNCHES)
        launches[name] = counts[name]
        results[family] = res
        sizes = {k: int(v[0].shape[0]) for k, v in sorted(res.levels.items())}
        plan = [(p.k_start, p.candidate_counts) for p in res.phases]
        print(f"mine impl={family}: {secs:.3f}s (scatter "
              f"{rt.stats.scatter_seconds:.3f}s, candidate generation "
              f"{sum(p.gen_seconds for p in res.phases):.3f}s, counting jobs "
              f"{sum(p.count_seconds for p in res.phases):.3f}s) "
              f"phases={res.n_phases} dispatches={res.dispatches} "
              f"launches={counts} levels={sizes} plan={plan}")
        if counts[name] <= 0 or any(v for k, v in counts.items() if k != name):
            raise AssertionError(f"impl={family} did not run on {name} alone")

    ref = results["vertical"].levels
    for family, res in results.items():
        if not _levels_equal(res.levels, ref):
            raise AssertionError(f"impl={family} levels differ from vertical")
    t1 = time.perf_counter()
    cpu = mine(db_masks=db, n_items=n_items, min_sup=MIN_SUP,
               algorithm=ALGORITHM, device="cpu")
    print(f"mine device=cpu impl=vertical (plain): "
          f"{time.perf_counter() - t1:.2f}s")
    if not _levels_equal(cpu.levels, ref):
        raise AssertionError("card levels differ from the CPU plain run")
    print("levels: all four families byte-identical, equal to the CPU run")

    small, n_small = dataset_by_name("c20d10k", seed=1, scale=0.03)
    oracle = sequential_apriori(small, MIN_SUP)
    for family in FAMILY.values():
        got = mine(small, n_items=n_small, min_sup=MIN_SUP,
                   algorithm=ALGORITHM,
                   runtime=MapReduceRuntime(impl=family, device="cuda"))
        if got.itemsets() != oracle:
            raise AssertionError(f"impl={family} differs from the oracle")
    print(f"oracle: {len(small)} txns, all four families equal "
          f"sequential_apriori")
    return launches, db, n_items, largest["cands"]


def time_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of ``fn()`` over ``reps`` calls, after a
    warm-up call."""
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


def library_overlap_count(a, width, b, valid=None, chunk=16384):
    """The matmul forms through ``torch._int_mm`` (cuBLASLt int8 tensor
    cores) plus compare-and-sum, over chunks of ``b``'s rows so the (M, N)
    int32 product stays a few GB.  Timed as a yardstick only."""
    out = torch.zeros(a.shape[0], dtype=torch.int32, device=a.device)
    for s in range(0, b.shape[0], chunk):
        bc = b[s:s + chunk]
        n = bc.shape[0]
        if n % 8:
            bc = torch.nn.functional.pad(bc, (0, 0, 0, 8 - n % 8))
        match = torch._int_mm(a, bc.T)[:, :n] == width[:, None]
        if valid is not None:
            match &= valid[s:s + n].bool()
        out += match.sum(dim=1, dtype=torch.int32)
    return out


def _library_support_count_matmul(cands, txns):
    return library_overlap_count(tunpack_bits(cands), tpopcount_rows(cands),
                                 tunpack_bits(txns))


def _library_vertical_count_matmul(vdb, idx):
    n_items = vdb.shape[0] - 1
    k = -(-n_items // 8) * 8
    A, nreal = vertical_membership(idx, n_items, k)
    vbits = tunpack_bits(vdb)
    planes = torch.nn.functional.pad(vbits[:n_items].T, (0, k - n_items))
    return library_overlap_count(A, nreal, planes.contiguous(),
                                 valid=vbits[n_items])


def phase_timing(launches, db, n_items, cands) -> list:
    device = torch.device("cuda")
    rt = MapReduceRuntime(impl="vertical", device=device)
    vdb = rt.scatter_db(db, n_items=n_items)
    idx_np = rt._padded_indices(cands)
    idx = torch.from_numpy(idx_np).to(device)
    words = to_device_words(cands, device)
    txns = to_device_words(db, device)
    C, W = cands.shape
    T, tw, kmax = db.shape[0], vdb.shape[1], idx_np.shape[1]
    k_real = np.maximum((idx_np != n_items).sum(axis=1), 1)
    print(f"largest phase: C={C} T={T} W={W} Tw={tw} kmax={kmax}")

    # bytes: every input read once, the (C,) int32 output written once;
    # operations: what these inputs need (real item slots, not kmax pads)
    vert_bytes = 4.0 * (vdb.numel() + idx.numel() + C)
    horz_bytes = 4.0 * (words.numel() + txns.numel() + C)
    work = {
        "vertical_count": (vert_bytes, tw * float((k_real + 1).sum()),
                           CUDA_CORE_OPS_PER_S),
        "support_count": (horz_bytes, 3.0 * W * C * T, CUDA_CORE_OPS_PER_S),
        "support_count_matmul": (horz_bytes, 2.0 * C * T * 32 * W,
                                 INT8_OPS_PER_S),
        "vertical_count_matmul": (vert_bytes, 2.0 * C * 32 * tw * n_items,
                                  INT8_OPS_PER_S),
    }
    args = {"vertical_count": (vdb, idx), "vertical_count_matmul": (vdb, idx),
            "support_count": (words, txns),
            "support_count_matmul": (words, txns)}
    library = {"support_count_matmul": _library_support_count_matmul,
               "vertical_count_matmul": _library_vertical_count_matmul}
    rows = []
    for name, (wrapper, plain) in kernels.KERNELS.items():
        a = args[name]
        err = _max_abs_diff(wrapper(*a), plain(*a))
        if name in library:
            err = max(err, _max_abs_diff(wrapper(*a), library[name](*a)))
        if err:
            raise AssertionError(f"{name} disagrees at the largest phase")
        ms = time_ms(lambda: wrapper(*a), 5)
        plain_ms = time_ms(lambda: plain(*a), 2)
        lib_ms = (time_ms(lambda: library[name](*a), 2)
                  if name in library else None)
        nbytes, ops, rate = work[name]
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
        row = {"name": name, "route": "cuda", "source": SOURCE,
               "replaces": REPLACES[name], "launches": launches[name],
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": 1e3 * max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": lib_ms}
        print(f"time {name}: max|diff|={err} {ms:.3f} ms (plain "
              f"{plain_ms:.3f}, library {lib_ms}, bound "
              f"{row['bound_ms']:.4f} by {row['bound_by']})")
        rows.append(row)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    kind = phase_device()
    phase_build()
    phase_kernels(device)
    launches, db, n_items, cands = phase_main()
    rows = phase_timing(launches, db, n_items, cands)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
