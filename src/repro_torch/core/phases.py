"""Multi-pass MapReduce phases — the paper's central construct.

A *phase* = candidate generation for one or more consecutive Apriori levels +
**one** counting job over the sharded database (one dispatch, one psum).

``simple`` phases (VFPC/ETDPC, paper §4.1) call ``apriori_gen`` (join + prune)
at every level; ``optimized`` phases (Optimized-VFPC/ETDPC, §4.2) prune only in
the first level and use ``non_apriori_gen`` (join only) afterwards —
skipped-pruning.  Both produce identical frequent itemsets (paper Fig. 1 and
our property tests): un-pruned candidates are false positives that support
counting removes.

Candidate rows are padded to the reference's power-of-two / 4096-multiple
buckets (DESIGN.md §2), so both packages count the same padded rows and their
dispatch and transfer statistics agree.

Device-resident pipeline (DESIGN.md §4): the min-support filter runs inside
the counting job and only a packed keep mask + filtered counts return to the
host; the job is dispatched **asynchronously**, and while it is in flight the
host speculatively joins the phase's last candidate level (parent-indexed,
see candidates.SpecJoin) so the *next* phase's first ``apriori_gen``
collapses to a pair-filter + prune.  The time spent generating while a job
is in flight is recorded as ``overlap_seconds``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.obs.trace import current_tracer

from .candidates import (SpecJoin, apriori_gen, non_apriori_gen, prune,
                         speculative_join)
from .mapreduce import MapReduceRuntime

MIN_BUCKET = 256


def wait_count(fut):
    """``fut.result()`` in a ``mine.count_wait`` span, whose ``sync_s`` is
    the future's own wait on the job's event (the copy back excluded)."""
    with current_tracer().span("mine.count_wait") as span:
        out = fut.result()
        span.set(sync_s=fut.wait_seconds)
    return out


def bucket_pad(cands: np.ndarray, min_bucket: int = MIN_BUCKET,
               granularity: int = 4096) -> np.ndarray:
    """Zero-pad rows to a bucketed size (compile-cache friendly).

    Small counts use power-of-two buckets (few shapes, cheap);
    large counts use multiples of ``granularity`` — §Perf iteration M-C:
    pow2 buckets pad up to 2× (counting work is proportional to the padded
    size), multiples of 4k bound waste at <4096 rows for a handful more
    compiles.
    """
    n, w = cands.shape
    if n <= granularity:
        b = min_bucket
        while b < n:
            b *= 2
    else:
        b = ((n + granularity - 1) // granularity) * granularity
    out = np.zeros((b, w), dtype=np.uint32)
    out[:n] = cands
    return out


@dataclasses.dataclass
class PhaseResult:
    k_start: int                       # first Apriori level counted in this phase
    npass: int                         # number of levels combined
    candidate_counts: list             # |C_k| per level (as generated)
    gen_seconds: float                 # candidate generation (join [+ prune]) time
    count_seconds: float               # counting job (dispatch + residual wait) time
    elapsed_seconds: float             # total phase wall time
    frequent_counts: list              # |L_k| per level after min_sup filter
    levels: dict                       # k -> (masks (n,W) uint32, counts (n,) int64)
    pruned: bool                       # True if every level pruned (simple phase)
    overlap_seconds: float = 0.0       # host gen overlapped with the in-flight job
    spec_seconds: float = 0.0          # total speculative-join time (next phase's gen)
    spec: SpecJoin | None = None       # speculative join of the last level
    last_keep: np.ndarray | None = None  # keep mask over the last level's candidates


def run_phase(runtime: MapReduceRuntime, db_sharded, n_txns: int,
              prev_frequent: np.ndarray, k_prev: int, min_count: float,
              npass: int | None = None, budget: float | None = None,
              optimized: bool = False, speculate: bool = False,
              spec: SpecJoin | None = None,
              prev_keep: np.ndarray | None = None,
              count_hook=None) -> PhaseResult:
    """Execute one (possibly multi-pass) MapReduce phase.

    Exactly one of ``npass`` (fixed width — SPC/FPC/VFPC style) or ``budget``
    (candidate budget ``ct`` — DPC/ETDPC style: generate levels while the
    cumulative candidate count ≤ ct, always at least one) must be given.

    The counting job filters on device (mask + filtered counts come home).
    ``speculate`` pre-joins the phase's last candidate level while the
    counting job is in flight, returning the result in ``PhaseResult.spec``
    for the *next* phase; a previous phase's ``spec`` + ``prev_keep`` (its
    keep mask) turn this phase's first join into an exact pair-filter
    (candidates.SpecJoin.resolve).  The join and the prune run on
    ``runtime.device`` where it is a card (core/candidates.py), on their own
    stream, so a speculative join never waits for the job in flight.
    ``count_hook``, if given, is called as ``count_hook("count_dispatch", k)``
    right after the counting job is dispatched — raising from it simulates a
    lost shard mid-job, which the driver's retry protocol recovers from
    (DESIGN.md §11).

    Returns a PhaseResult with per-level frequent itemsets.
    """
    assert (npass is None) != (budget is None), "exactly one of npass/budget"
    tracer = current_tracer()
    t0 = time.perf_counter()
    levels_cands: list[np.ndarray] = []
    cur = prev_frequent
    p, total = 0, 0
    gen_span = tracer.span("mine.gen", k_start=k_prev + 1)
    while True:
        if p == 0 and spec is not None and prev_keep is not None:
            # first-level join precomputed during the previous phase's count
            cands = prune(spec.resolve(prev_keep), prev_frequent, k_prev,
                          device=runtime.device)
        else:
            gen = apriori_gen if (p == 0 or not optimized) else non_apriori_gen
            cands = gen(cur, k_prev + p, device=runtime.device)
        if cands.shape[0] == 0:
            break
        levels_cands.append(cands)
        total += cands.shape[0]
        cur = cands
        p += 1
        if npass is not None and p >= npass:
            break
        if budget is not None and total > budget:
            break
    t_gen = time.perf_counter() - t0
    gen_span.set(n_levels=len(levels_cands), n_candidates=total).close()

    if not levels_cands:
        return PhaseResult(k_prev + 1, 0, [], t_gen, 0.0,
                           time.perf_counter() - t0, [], {}, not optimized)

    all_cands = np.concatenate(levels_cands, axis=0)
    padded = bucket_pad(all_cands)
    t1 = time.perf_counter()
    count_span = tracer.span(
        "mine.count", k_start=k_prev + 1, npass=len(levels_cands),
        n_candidates=int(all_cands.shape[0]), padded=int(padded.shape[0]),
        impl=runtime.impl)
    fut = runtime.phase_count_async(db_sharded, padded, min_count=min_count,
                                    n_valid=all_cands.shape[0])
    count_span.event("count.dispatch")
    if count_hook is not None:
        count_hook("count_dispatch", k_prev + 1)

    # -- overlap window: speculative next-phase join while the job is in flight
    spec_next, t_spec, overlapped = None, 0.0, 0.0
    if speculate:
        in_flight = not fut.ready()
        ts = time.perf_counter()
        with tracer.span("mine.spec_join", k=k_prev + len(levels_cands) + 1,
                         in_flight=in_flight):
            spec_next = speculative_join(levels_cands[-1],
                                         k_prev + len(levels_cands),
                                         device=runtime.device)
        t_spec = time.perf_counter() - ts
        if in_flight:
            # upper bound: the job may complete mid-join; count_seconds below
            # holds the residual wait, so the pair is self-consistent
            overlapped = t_spec
            runtime.stats.overlap_seconds += overlapped

    keep_all, counts_all = wait_count(fut)
    t_count = max(time.perf_counter() - t1 - t_spec, 0.0)
    count_span.set(count_seconds=t_count, overlap_seconds=overlapped).close()

    counts = counts_all[:all_cands.shape[0]]
    levels = {}
    freq_counts = []
    last_keep = None
    off = 0
    for i, cands in enumerate(levels_cands):
        c = counts[off:off + cands.shape[0]]
        keep = keep_all[off:off + cands.shape[0]]
        off += cands.shape[0]
        levels[k_prev + 1 + i] = (cands[keep], c[keep])
        freq_counts.append(int(keep.sum()))
        last_keep = keep
    return PhaseResult(
        k_start=k_prev + 1, npass=len(levels_cands),
        candidate_counts=[int(c.shape[0]) for c in levels_cands],
        gen_seconds=t_gen, count_seconds=t_count,
        elapsed_seconds=time.perf_counter() - t0,
        frequent_counts=freq_counts, levels=levels, pruned=not optimized,
        overlap_seconds=overlapped, spec_seconds=t_spec, spec=spec_next,
        last_keep=last_keep)
