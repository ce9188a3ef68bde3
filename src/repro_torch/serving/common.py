"""Shared serving-layer helpers (DESIGN.md §7/§8): the port's copy of the
JAX package's ``serving/common.py``.

Query bit-packing, pow2 query-shape bucketing and the per-query latency
roll-up, shared by the rule-serving engine, the streaming miner and the
CLIs.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.bitset import pack_itemsets
from repro_torch.kernels.autotune import _bucket

MIN_QUERY_BUCKET = 8


def bucket_rows(n: int, floor: int = MIN_QUERY_BUCKET) -> int:
    """Power-of-two row bucket ≥ n — a handful of dispatch shapes.
    Same rounding as the autotuner's shape buckets, floored for tiny batches."""
    return max(floor, _bucket(n))


def pack_baskets(baskets, n_items: int) -> np.ndarray:
    """Item-id baskets → (Q, W) uint32 bitsets; unknown ids are ignored."""
    clean = [[i for i in b if 0 <= i < n_items] for b in baskets]
    return pack_itemsets(clean, n_items)


def latency_ms(records) -> np.ndarray:
    """Per-query dispatch latencies in ms from a serve-record trace.

    Each record's elapsed time is attributed to every query it answered
    (empty dispatches count once), so percentiles weight by queries served.
    """
    if not records:
        return np.zeros(0, np.float64)
    return np.repeat([r.elapsed * 1e3 for r in records],
                     [max(r.n_queries, 1) for r in records])


def latency_percentiles(records) -> dict:
    """{"p50_ms", "p99_ms"} of the per-query dispatch latency."""
    lat = latency_ms(records)
    if lat.size == 0:
        return {"p50_ms": 0.0, "p99_ms": 0.0}
    return {"p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99))}


def outcome_summary(outcomes) -> dict:
    """Roll up open-loop :class:`~repro_torch.serving.admission.QueryOutcome` rows.

    Answered-query latency percentiles (served + cached — cache hits are real
    answers at zero latency; shed queries got no answer so they don't get a
    latency, they get a shed rate), overall shed/cache rates, and the
    per-tenant admitted/shed split fairness assertions read.
    """
    n = len(outcomes)
    served = [o for o in outcomes if o.outcome == "served"]
    cached = [o for o in outcomes if o.outcome == "cached"]
    shed = [o for o in outcomes if o.outcome == "shed"]
    lat = np.asarray([o.latency_s * 1e3 for o in served + cached
                      if o.latency_s is not None], np.float64)
    tenants: dict = {}
    for o in outcomes:
        row = tenants.setdefault(o.tenant, {"offered": 0, "answered": 0,
                                            "shed": 0})
        row["offered"] += 1
        row["shed" if o.outcome == "shed" else "answered"] += 1
    return {
        "n_queries": n,
        "served": len(served),
        "cached": len(cached),
        "shed": len(shed),
        "shed_rate": len(shed) / n if n else 0.0,
        "cache_hit_rate": len(cached) / n if n else 0.0,
        "p50_ms": float(np.percentile(lat, 50)) if lat.size else 0.0,
        "p99_ms": float(np.percentile(lat, 99)) if lat.size else 0.0,
        "tenants": tenants,
    }
