#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py     # a few minutes on an H100, one of them
                              # spent generating c20d200k on the host

Phases, each printing its own lines; any failure raises and the process exits
non-zero without printing a result:

1. device   — the card's name and count, and ``nvidia-smi``'s name and power
              limit;
2. build    — every CUDA source under ``src/repro_torch/csrc`` compiled by
              ``nvcc`` for sm_90a, one process each, all started together;
3. kernels  — each hand-written kernel against its plain PyTorch version on
              the card at small ragged shapes: exact equality (integer counts,
              and float32 score bits for the rule kernels);
4. main     — ``mine()`` on the paper's speed-up dataset c20d200k (200,000
              transactions, 192 items, average width 20), min_sup 0.125,
              optimized_vfpc, once with each counting family on the card; each
              family's kernel launch count is set to 0 just before its run and
              read just after.  All four must give byte-identical levels, equal
              to the port's CPU run with the plain vertical version, and the
              port must equal the sequential oracle on a small input;
6. serving  — full-scale mushroom (8,124 transactions, 119 items) split
              round-robin into 4 tenants, each mined on the card at min_sup
              0.2 and turned into rules at min_conf 0.7 (arrays bitwise equal
              to a CPU run of the port); 4,096 mixed-tenant queries served
              through one RuleStore arena in batches of 32 (max_fuse 16,
              top-5), once with each scoring family on the card: each
              family's kernel alone launches, the recommendations are
              identical across families, equal to a CPU run and, on the
              first 256 queries, to a numpy brute-force oracle; then one
              open-loop run at a fixed offered rate under an SLO;
7. stream   — mushroom through a sliding window of 4,096 transactions at
              min_sup 0.2 / min_conf 0.7: prefill, then 16 updates of 256,
              once with each delta family; after every update the published
              levels equal a from-scratch mine of the window;
5. timing   — each kernel at its path's largest shape (counting: the mining
              path's largest phase; rules: 512 padded queries against the
              arena; delta: the tracked candidates against the 512-row slab):
              exact equality with its plain version, then CUDA-event times of
              the kernel, the plain version and (matmul forms) ``torch._int_mm``
              plus compare-and-select, beside the least time the card could
              take; and the time of the top-k that follows the rule kernels.

Phases run in the order 1, 2, 3, 4, 6, 7, 5.  Each path's launch counts are
set to 0 just before it is driven and read just after.  The line before the
last is ``{"kernels": [...]}``; the last line is ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from argparse import Namespace

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.core import MapReduceRuntime, mine, sequential_apriori  # noqa: E402
from repro_torch.core.bitset import (pack_itemsets, to_device_words,  # noqa: E402
                                     tpopcount_rows, tunpack_bits,
                                     vertical_pack)
from repro_torch.costmodel import CostController, CostModel  # noqa: E402
from repro_torch.data import dataset_by_name  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.delta_count import build_slab  # noqa: E402
from repro_torch.kernels.vertical_count import vertical_membership  # noqa: E402
from repro_torch.launch.serve_rules import (make_queries, mine_tenants,  # noqa: E402
                                            serve_open_loop)
from repro_torch.serving import RuleServeEngine, RuleStore, stable_top_k  # noqa: E402
from repro_torch.serving.common import bucket_rows, latency_ms  # noqa: E402
from repro_torch.stream import StreamMiner, levels_equal  # noqa: E402
import repro_torch.stream.miner as stream_miner  # noqa: E402

DATASET, MIN_SUP, ALGORITHM = "c20d200k", 0.125, "optimized_vfpc"

# NVIDIA H100 SXM peaks at the full 700 W power limit (NVIDIA's data sheet,
# dense rates): 3.35 TB/s of HBM3 and 1,979 TOP/s of int8 tensor cores.  The
# popcount kernels do 32-bit integer work on the CUDA cores, for which the
# data sheet lists no rate; their bound uses its CUDA-core float32 rate,
# 67 TFLOP/s, which is at least the integer rate, so the bound stays a bound.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
CUDA_CORE_OPS_PER_S = 67e12

# serving and streaming configuration (phases 6 and 7)
SERVE_DATASET, SERVE_MIN_SUP, SERVE_MIN_CONF = "mushroom", 0.2, 0.7
N_TENANTS, N_QUERIES, SERVE_BATCH, MAX_FUSE, TOP_K = 4, 4096, 32, 16, 5
ORACLE_QUERIES = 256
OPEN_LOOP_QPS, OPEN_LOOP_SLO_MS = 8000.0, 25.0
CAPACITY, STREAM_BATCH, STREAM_UPDATES = 4096, 256, 16

# kernel name → the runtime family that reaches it, and the TPU kernel it replaces
FAMILY = {"vertical_count": "vertical", "support_count": "jnp",
          "support_count_matmul": "matmul",
          "vertical_count_matmul": "vertical_matmul"}
RULE_FAMILY = {"rule_scores": "jnp", "rule_scores_matmul": "matmul"}
DELTA_FAMILY = {"delta_count": "jnp", "delta_count_matmul": "matmul"}
REPLACES = {
    "support_count": "src/repro/kernels/support_count.py:36",
    "support_count_matmul": "src/repro/kernels/support_count.py:129",
    "vertical_count": "src/repro/kernels/vertical_count.py:43",
    "vertical_count_matmul": "src/repro/kernels/vertical_count.py:190",
    "delta_count": "src/repro/kernels/delta_count.py:50",
    "delta_count_matmul": "src/repro/kernels/delta_count.py:172",
    "rule_scores": "src/repro/kernels/rule_match.py:40",
    "rule_scores_matmul": "src/repro/kernels/rule_match.py:201",
}
SOURCE = {name: "src/repro_torch/csrc/counting.cu" for name in FAMILY}
SOURCE.update({name: "src/repro_torch/csrc/delta_count.cu"
               for name in DELTA_FAMILY})
SOURCE.update({name: "src/repro_torch/csrc/rule_match.cu"
               for name in RULE_FAMILY})


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
    horizontal, signed = [], []
    # W = 9 and 17 take the counting kernels' chunked instance for W > 8
    for C, T, W in ((1, 1, 1), (17, 33, 2), (300, 700, 8), (1000, 4099, 6),
                    (45, 600, 9), (300, 1025, 17)):
        c = rng.integers(0, 2 ** 32, (C, W), dtype=np.uint32)
        t = rng.integers(0, 2 ** 32, (T, W), dtype=np.uint32)
        c[0] = 0
        c[-1] &= t[0]                 # contained in at least one row
        sign = rng.integers(-1, 2, T).astype(np.int32)
        horizontal.append((to_device_words(c, device),
                           to_device_words(t, device)))
        signed.append(horizontal[-1] + (torch.from_numpy(sign).to(device),))
    vertical = []
    for n_items, n, kmax, C in ((37, 101, 5, 23), (192, 5003, 4, 777)):
        vdb, idx = _random_vertical(rng, n_items, n, kmax, C)
        vertical.append((to_device_words(vdb, device),
                         torch.from_numpy(idx).to(device)))
    rules = []
    for R, Q, W in ((1, 1, 1), (37, 13, 2), (700, 70, 4), (1000, 45, 9)):
        def sparse(n):     # AND of three draws: a quarter of the bits set
            return (rng.integers(0, 2 ** 32, (n, W), dtype=np.uint32)
                    & rng.integers(0, 2 ** 32, (n, W), dtype=np.uint32)
                    & rng.integers(0, 2 ** 32, (n, W), dtype=np.uint32))
        ante, cons = sparse(R), sparse(R)
        baskets = ~sparse(Q)
        ante[-1] = 0                      # an empty antecedent fires always
        scores = rng.random(R).astype(np.float32)
        scores[0] = np.inf                # +inf is a legal score
        for exclude in (True, False):
            rules.append((to_device_words(ante, device),
                          to_device_words(cons, device),
                          torch.from_numpy(scores).to(device),
                          to_device_words(baskets, device), exclude))
    return {"support_count": horizontal, "support_count_matmul": horizontal,
            "vertical_count": vertical, "vertical_count_matmul": vertical,
            "delta_count": signed, "delta_count_matmul": signed,
            "rule_scores": rules, "rule_scores_matmul": rules}


def _max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """0 when the two tensors hold the same values (for float32: the same
    bits, -inf included); else the largest absolute difference."""
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {a.shape} vs {b.shape}")
    if not a.numel():
        return 0
    if a.is_floating_point():
        if torch.equal(a.view(torch.int32), b.view(torch.int32)):
            return 0
        return float((a.double() - b.double()).abs().nan_to_num(
            nan=float("inf")).max())
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


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


def _library_rule_scores_matmul(antes, cons, scores, baskets, exclude):
    """The matmul rule form through ``torch._int_mm`` (rules padded to a
    multiple of 8 rows, as it requires) plus compare-and-select.  Timed as
    a yardstick only."""
    R = antes.shape[0]
    pad = (0, 0, 0, (-R) % 8)
    bb = tunpack_bits(baskets)
    ab = torch.nn.functional.pad(tunpack_bits(antes), pad)
    ok = torch._int_mm(bb, ab.T)[:, :R] == tpopcount_rows(antes)[None, :]
    if exclude:
        cb = torch.nn.functional.pad(tunpack_bits(cons), pad)
        ok &= torch._int_mm(bb, cb.T)[:, :R] != tpopcount_rows(cons)[None, :]
    return torch.where(ok, scores[None, :],
                       torch.tensor(float("-inf"), device=scores.device))


def _library_delta_count_matmul(cands, txns, signs):
    T = txns.shape[0]
    tb = torch.nn.functional.pad(tunpack_bits(txns), (0, 0, 0, (-T) % 8))
    match = (torch._int_mm(tunpack_bits(cands), tb.T)[:, :T]
             == tpopcount_rows(cands)[:, None])
    return torch.where(match, signs[None, :], 0).sum(dim=1, dtype=torch.int32)


def phase_timing(launches, db, n_items, cands, rule_args, delta_args) -> list:
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
    ante, cons, scores, baskets, _ = rule_args
    R, RW, Qp = ante.shape[0], ante.shape[1], baskets.shape[0]
    print(f"largest rule dispatch: Qp={Qp} R={R} W={RW}")
    dc, slab, signs = delta_args
    DC, DT, DW = dc.shape[0], slab.shape[0], dc.shape[1]
    print(f"largest delta update: C={DC} T={DT} W={DW}")

    # bytes: every input read once, the output written once; operations:
    # what these inputs need (real item slots, not kmax pads)
    vert_bytes = 4.0 * (vdb.numel() + idx.numel() + C)
    horz_bytes = 4.0 * (words.numel() + txns.numel() + C)
    rule_bytes = 4.0 * (2 * R * RW + R + Qp * RW + Qp * R)
    delta_bytes = 4.0 * (DC * DW + DT * DW + DT + DC)
    work = {
        "vertical_count": (vert_bytes, tw * float((k_real + 1).sum()),
                           CUDA_CORE_OPS_PER_S),
        "support_count": (horz_bytes, 3.0 * W * C * T, CUDA_CORE_OPS_PER_S),
        "support_count_matmul": (horz_bytes, 2.0 * C * T * 32 * W,
                                 INT8_OPS_PER_S),
        "vertical_count_matmul": (vert_bytes, 2.0 * C * 32 * tw * n_items,
                                  INT8_OPS_PER_S),
        # AND and compare of ante and cons words, then one select
        "rule_scores": (rule_bytes, Qp * R * (4.0 * RW + 1),
                        CUDA_CORE_OPS_PER_S),
        "rule_scores_matmul": (rule_bytes, 2 * 2.0 * Qp * R * 32 * RW,
                               INT8_OPS_PER_S),
        "delta_count": (delta_bytes, 3.0 * DW * DC * DT, CUDA_CORE_OPS_PER_S),
        "delta_count_matmul": (delta_bytes, 2.0 * DC * DT * 32 * DW,
                               INT8_OPS_PER_S),
    }
    args = {"vertical_count": (vdb, idx), "vertical_count_matmul": (vdb, idx),
            "support_count": (words, txns),
            "support_count_matmul": (words, txns),
            "rule_scores": rule_args, "rule_scores_matmul": rule_args,
            "delta_count": delta_args, "delta_count_matmul": delta_args}
    library = {"support_count_matmul": _library_support_count_matmul,
               "vertical_count_matmul": _library_vertical_count_matmul,
               "rule_scores_matmul": _library_rule_scores_matmul,
               "delta_count_matmul": _library_delta_count_matmul}
    rows = []
    for name, (wrapper, plain) in kernels.KERNELS.items():
        a = args[name]
        err = _max_abs_diff(wrapper(*a), plain(*a))
        if name in library:
            err = max(err, _max_abs_diff(wrapper(*a), library[name](*a)))
        if err:
            raise AssertionError(f"{name} disagrees at its largest shape")
        ms = time_ms(lambda: wrapper(*a), 5)
        plain_ms = time_ms(lambda: plain(*a), 2)
        lib_ms = (time_ms(lambda: library[name](*a), 2)
                  if name in library else None)
        nbytes, ops, rate = work[name]
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
        row = {"name": name, "route": "cuda", "source": SOURCE[name],
               "replaces": REPLACES[name], "launches": launches[name],
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": 1e3 * max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": lib_ms}
        print(f"time {name}: max|diff|={err} {ms:.3f} ms (plain "
              f"{plain_ms:.3f}, library {lib_ms}, bound "
              f"{row['bound_ms']:.4f} by {row['bound_by']})")
        rows.append(row)

    # the top-k after the rule kernels is a plain torch op, not a kernel
    s = kernels.rule_scores_matmul(*rule_args)
    kf = min(TOP_K * 8, R)
    topk_ms = time_ms(lambda: stable_top_k(s, kf), 5)
    unstable_ms = time_ms(lambda: torch.topk(s, kf, dim=1), 5)
    print(f"time stable_top_k (Qp={Qp}, R={R}, k={kf}): {topk_ms:.3f} ms "
          f"(torch.topk alone, ties unordered: {unstable_ms:.3f} ms)")
    return rows


def _mine_tenants(txns, n_items, device):
    """The serving CLI's tenant split, mined and turned into rules on
    ``device``."""
    args = Namespace(min_sup=SERVE_MIN_SUP, min_conf=SERVE_MIN_CONF,
                     mine_algorithm=ALGORITHM, device=device)
    return mine_tenants(txns, n_items, N_TENANTS, args)


def _ruleset_equal(a, b) -> bool:
    for f in ("ante_masks", "cons_masks", "union_counts", "ante_counts",
              "cons_counts", "confidence", "lift", "leverage", "score"):
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if x.tobytes() != y.tobytes():
            return False
    return a.n_items == b.n_items and a.n_txns == b.n_txns


def _oracle(rulesets, pair, kf: int):
    """Brute-force recommendations of one (tenant, basket) query in numpy:
    every rule of the tenant whose antecedent the basket holds and whose
    consequent it does not, by score (ties lowest index first), cut to the
    engine's ``kf`` fetched slots, consequents de-duplicated, top ``TOP_K``."""
    name, basket = pair
    rs = rulesets[name]
    b = pack_itemsets([[i for i in basket if 0 <= i < rs.n_items]],
                      rs.n_items)[0]
    ok = (((rs.ante_masks & b) == rs.ante_masks).all(axis=1)
          & ~((rs.cons_masks & b) == rs.cons_masks).all(axis=1))
    hits = np.nonzero(ok)[0]
    hits = hits[np.argsort(-rs.score[hits], kind="stable")][:kf]
    out, seen = [], set()
    for r in hits:
        cons = tuple(int(i) for i in np.nonzero(np.unpackbits(
            rs.cons_masks[r].view(np.uint8), bitorder="little"))[0])
        if cons in seen:
            continue
        seen.add(cons)
        out.append((cons, float(rs.score[r])))
        if len(out) == TOP_K:
            break
    return out


def _serving_split(eng, queries, reps: int = 4) -> dict:
    """Mean per-dispatch ms of each step of a fused 512-query dispatch:
    host pack, upload, scoring kernel, top-k, transfer home, host decode."""
    state = eng.store.state
    scorer = kernels.KERNELS[
        {v: k for k, v in RULE_FAMILY.items()}[eng.family]][0]
    kf = min(TOP_K * 8, len(state))
    n = SERVE_BATCH * MAX_FUSE
    split = dict.fromkeys(("pack", "upload", "kernel", "top_k", "to_host",
                           "decode"), 0.0)
    for i in range(reps):
        pairs = queries[i * n:(i + 1) * n]
        t = [time.perf_counter()]
        packed = state.pack(pairs)
        packed = np.concatenate([packed, np.zeros(
            (bucket_rows(n) - n, state.W), np.uint32)])
        t.append(time.perf_counter())
        baskets = to_device_words(packed, state.device)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        s = scorer(state.d_ante, state.d_cons, state.d_scores, baskets)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        vals, idx = stable_top_k(s[:n], kf)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        t.append(time.perf_counter())
        eng._decode(state, vals, idx, TOP_K)
        t.append(time.perf_counter())
        for key, a, b in zip(split, t, t[1:]):
            split[key] += 1e3 * (b - a) / reps
    return split


def phase_serving():
    """Drive rule serving with each scoring family; return the launches of
    the rule kernels and the arguments of the largest rule dispatch."""
    txns, n_items = dataset_by_name(SERVE_DATASET, seed=0)
    t0 = time.perf_counter()
    tenants, slices = _mine_tenants(txns, n_items, "cuda")
    gen_s = time.perf_counter() - t0
    counts = {t: len(r) for t, r in tenants.items()}
    widths = {t: r.ante_masks.shape[1] for t, r in tenants.items()}
    t0 = time.perf_counter()
    cpu_tenants, _ = _mine_tenants(txns, n_items, "cpu")
    cpu_s = time.perf_counter() - t0
    for t in tenants:
        if not _ruleset_equal(tenants[t], cpu_tenants[t]):
            raise AssertionError(f"tenant {t}: card RuleSet differs from CPU")
    store = RuleStore(tenants=tenants, device="cuda")
    print(f"rules: {SERVE_DATASET} n_txns={len(txns)} n_items={n_items} "
          f"{N_TENANTS} tenants mined + rules on the card in {gen_s:.2f}s "
          f"(CPU {cpu_s:.2f}s): {sum(counts.values())} rules {counts}, "
          f"W={widths} arena W={store.state.W}; RuleSet arrays bitwise "
          f"equal to the CPU run")

    names = list(tenants)
    queries = [(names[i % N_TENANTS],
                make_queries(slices[names[i % N_TENANTS]], 1, seed=1 + i)[0])
               for i in range(N_QUERIES)]
    batches = [queries[i:i + SERVE_BATCH]
               for i in range(0, N_QUERIES, SERVE_BATCH)]
    launches, results = {}, {}
    for name, family in RULE_FAMILY.items():
        eng = RuleServeEngine(store, top_k=TOP_K, impl=family,
                              max_fuse=MAX_FUSE, device="cuda")
        eng.warmup(SERVE_BATCH * MAX_FUSE)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t1 = time.perf_counter()
        results[family], records = eng.serve(batches)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        counts = dict(kernels.LAUNCHES)
        launches[name] = counts[name]
        lat = latency_ms(records)
        print(f"serve impl={family}: {N_QUERIES} queries in {secs:.3f}s = "
              f"{N_QUERIES / secs:,.0f} qps, {len(records)} dispatches, "
              f"p50={np.percentile(lat, 50):.3f} ms "
              f"p99={np.percentile(lat, 99):.3f} ms, launches="
              f"{ {k: v for k, v in counts.items() if v} }")
        if counts[name] <= 0 or any(v for k, v in counts.items() if k != name):
            raise AssertionError(f"impl={family} did not run on {name} alone")
        split = _serving_split(eng, queries)
        print(f"serve impl={family} split per {SERVE_BATCH * MAX_FUSE}-query "
              f"dispatch (ms): " + ", ".join(
                  f"{k} {v:.3f}" for k, v in split.items()))
    if results["jnp"] != results["matmul"]:
        raise AssertionError("the two scoring families recommend differently")

    cpu_store = RuleStore(tenants=cpu_tenants, device="cpu")
    t1 = time.perf_counter()
    cpu, _ = RuleServeEngine(cpu_store, top_k=TOP_K, impl="jnp",
                             max_fuse=MAX_FUSE, device="cpu").serve(batches)
    print(f"serve device=cpu impl=jnp (plain): "
          f"{time.perf_counter() - t1:.2f}s")
    if cpu != results["jnp"]:
        raise AssertionError("card recommendations differ from the CPU run")
    flat = [recs for batch in results["jnp"] for recs in batch]
    kf = min(TOP_K * 8, len(store.state))
    for pair, recs in zip(queries[:ORACLE_QUERIES], flat):
        if [(r.consequent, r.score) for r in recs] != _oracle(cpu_tenants,
                                                              pair, kf):
            raise AssertionError(f"query {pair} differs from the oracle")
    n_recs = sum(len(r) for r in flat)
    print(f"recommendations: {n_recs} over {N_QUERIES} queries, identical "
          f"for both families and the CPU run; the first {ORACLE_QUERIES} "
          f"equal the numpy brute-force oracle")

    controller = CostController(model=CostModel(persist=False))
    eng = RuleServeEngine(store, top_k=TOP_K, max_fuse=MAX_FUSE,
                          controller=controller, device="cuda")
    eng.warmup(SERVE_BATCH)
    record: dict = {}
    serve_open_loop(eng, queries, Namespace(
        latency_slo_ms=OPEN_LOOP_SLO_MS, batch=SERVE_BATCH, max_wait_ms=5.0,
        cache_size=256, no_fair_shedding=False, seed=0,
        rate_qps=OPEN_LOOP_QPS), controller, record)
    ol = record["open_loop"]
    print(f"open loop impl={eng.family} on {torch.cuda.get_device_name(0)}: "
          f"offered {OPEN_LOOP_QPS:,.0f} qps, sustained "
          f"{ol['sustained_qps']:,.0f} qps, p99 {ol['p99_ms']:.3f} ms "
          f"(SLO {OPEN_LOOP_SLO_MS} ms), shed rate {ol['shed_rate']:.4f}")

    n = SERVE_BATCH * MAX_FUSE
    packed = store.state.pack(queries[:n])
    baskets = to_device_words(np.concatenate([packed, np.zeros(
        (bucket_rows(n) - n, store.state.W), np.uint32)]), "cuda")
    rule_args = (store.state.d_ante, store.state.d_cons, store.state.d_scores,
                 baskets, True)
    return launches, rule_args, queries


def phase_stream():
    """Stream mushroom through a sliding window with each delta family;
    return the launches of the delta kernels and the largest update's
    arguments."""
    txns, n_items = dataset_by_name(SERVE_DATASET, seed=0)
    largest: dict = {}
    delta_count = stream_miner.delta_count

    def record(cands, added, evicted, **kw):
        if cands.shape[0] >= largest.get("cands", np.zeros((0,))).shape[0]:
            largest.update(cands=cands, added=added, evicted=evicted)
        return delta_count(cands, added, evicted, **kw)
    stream_miner.delta_count = record
    launches = {}
    try:
        for name, family in DELTA_FAMILY.items():
            miner = StreamMiner(n_items, SERVE_MIN_SUP, capacity=CAPACITY,
                                min_confidence=SERVE_MIN_CONF, impl=family,
                                device="cuda")
            torch.cuda.synchronize()
            kernels.reset_launches()
            fill = min(len(txns), CAPACITY)
            rec = miner.push(txns[:fill])
            print(f"stream impl={family} prefill: {fill} txns → "
                  f"{rec.n_frequent} frequent itemsets, {rec.n_rules} rules "
                  f"({rec.path}, {rec.update_seconds:.3f}s), tracked "
                  f"{miner.n_tracked}")
            paths: dict = {}
            for u in range(STREAM_UPDATES):
                lo = (fill + u * STREAM_BATCH) % max(len(txns) - STREAM_BATCH,
                                                     1)
                rec = miner.push(txns[lo:lo + STREAM_BATCH])
                paths[rec.path] = paths.get(rec.path, 0) + 1
                scratch = mine(db_masks=miner.window.contents(),
                               n_items=n_items, min_sup=SERVE_MIN_SUP,
                               algorithm=miner.algorithm,
                               runtime=MapReduceRuntime(device="cuda"))
                if not levels_equal(miner.levels, scratch.levels):
                    raise AssertionError(
                        f"update {u} ({rec.path}) differs from scratch")
                print(f"  update {u}: {rec.path} +{rec.n_added}/"
                      f"-{rec.n_evicted} {1e3 * rec.update_seconds:.2f} ms "
                      f"(delta {1e3 * rec.delta_seconds:.2f}, re-mine "
                      f"{1e3 * rec.remine_seconds:.2f}, refresh "
                      f"{1e3 * rec.refresh_seconds:.2f}) frequent="
                      f"{rec.n_frequent} rules={rec.n_rules}")
            torch.cuda.synchronize()
            counts = dict(kernels.LAUNCHES)
            launches[name] = counts[name]
            print(f"stream impl={family}: paths {paths}, tracked "
                  f"{miner.n_tracked}, launches "
                  f"{ {k: v for k, v in counts.items() if v} }; every "
                  f"update equals a scratch mine of the window")
            other = [k for k in DELTA_FAMILY if k != name]
            if counts[name] <= 0 or any(counts[k] for k in other):
                raise AssertionError(f"impl={family} did not run on {name} "
                                     f"alone")
    finally:
        stream_miner.delta_count = delta_count
    slab, signs = build_slab(largest["added"], largest["evicted"])
    delta_args = (to_device_words(largest["cands"], "cuda"),
                  to_device_words(slab, "cuda"),
                  torch.from_numpy(signs).to("cuda"))
    return launches, delta_args


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    t0 = time.perf_counter()
    kind = phase_device()
    phase_build()
    phase_kernels(device)
    launches, db, n_items, cands = phase_main()
    rule_launches, rule_args, _ = phase_serving()
    delta_launches, delta_args = phase_stream()
    launches.update(rule_launches)
    launches.update(delta_launches)
    rows = phase_timing(launches, db, n_items, cands, rule_args, delta_args)
    print(f"total: {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
