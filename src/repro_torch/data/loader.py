"""Transaction-file IO and shard balancing.

File format: one transaction per line, space-separated item ids (the standard
FIMI repository format the paper's datasets use).
"""

from __future__ import annotations

import heapq

import numpy as np

from repro_torch.core.bitset import pack_itemsets, popcount_rows


def save_transactions(path: str, transactions) -> None:
    with open(path, "w") as f:
        for t in transactions:
            f.write(" ".join(str(i) for i in t) + "\n")


def load_transactions(path: str) -> tuple[list[list[int]], int]:
    """Load FIMI-format transactions. Returns (transactions, n_items)."""
    txns = []
    max_item = -1
    with open(path) as f:
        for line in f:
            row = [int(x) for x in line.split()]
            if row:
                txns.append(row)
                max_item = max(max_item, max(row))
    return txns, max_item + 1


def dataset_stats(transactions, n_items: int) -> dict:
    if len(transactions) == 0:
        # streaming windows are routinely empty; zero stats, no NaN/ValueError
        return {"n_txns": 0, "n_items": n_items, "avg_width": 0.0,
                "max_width": 0, "density": 0.0}
    widths = np.array([len(t) for t in transactions])
    return {
        "n_txns": len(transactions),
        "n_items": n_items,
        "avg_width": float(widths.mean()),
        "max_width": int(widths.max()),
        "density": float(widths.mean() / n_items) if n_items else 0.0,
    }


def balance_shards(transactions, n_shards: int) -> list[list[int]]:
    """Static straggler mitigation: order transactions so that per-shard total
    width (≈ per-mapper work) is balanced under round-robin sharding.

    Greedy LPT assignment by width, then interleave shards back into a single
    ordering whose round-robin split reproduces the balanced assignment.
    """
    order = np.argsort([-len(t) for t in transactions], kind="stable")
    loads = np.zeros(n_shards, dtype=np.int64)
    shards: list[list[int]] = [[] for _ in range(n_shards)]
    for idx in order:
        s = int(np.argmin(loads))
        shards[s].append(int(idx))
        loads[s] += len(transactions[idx])
    # interleave: row-major over (position, shard) — round-robin recovers shards
    out = []
    maxlen = max(len(s) for s in shards)
    for pos in range(maxlen):
        for s in range(n_shards):
            if pos < len(shards[s]):
                out.append(transactions[shards[s][pos]])
    return out


def _contiguous_shard_sizes(n: int, n_shards: int) -> list[int]:
    """Real-row counts per shard of ``scatter_db``'s contiguous equal split:
    rows are padded to the shard multiple at the *end*, so every shard holds
    ``ceil(n/d)`` rows and only the tail shards see the zero padding."""
    per = (n + (-n) % n_shards) // n_shards
    return [max(0, min(per, n - s * per)) for s in range(n_shards)]


def shard_width_loads(db_masks: np.ndarray, n_shards: int) -> np.ndarray:
    """Per-shard total transaction width under the contiguous equal split
    ``scatter_db`` produces — the straggler-skew input the cost controller
    prices against the rebalance cost (DESIGN.md §11)."""
    n = db_masks.shape[0]
    if n_shards <= 1 or n == 0:
        return np.array([float(popcount_rows(db_masks).sum())] if n else [0.0])
    per = (n + (-n) % n_shards) // n_shards
    w = popcount_rows(db_masks).astype(np.float64)
    pad = per * n_shards - n
    if pad:
        w = np.concatenate([w, np.zeros(pad)])
    return w.reshape(n_shards, per).sum(axis=1)


def balance_masks(db_masks: np.ndarray, n_shards: int) -> np.ndarray:
    """Reorder packed transactions so the *contiguous* equal split has
    balanced per-shard total width (capacity-constrained LPT).

    Unlike :func:`balance_shards` (which interleaves for a round-robin
    split), this matches how ``MapReduceRuntime.scatter_db`` actually
    shards: contiguous blocks of ``ceil(n/d)`` rows.  Each shard's capacity
    is its real-row count under that split (the zero padding shrinks only
    the tail shards), so the permutation is exact — counting is a sum over
    transactions, so the mining result is bit-identical either way.
    """
    n = db_masks.shape[0]
    if n_shards <= 1 or n <= n_shards:
        return db_masks
    caps = _contiguous_shard_sizes(n, n_shards)
    widths = popcount_rows(db_masks).astype(np.int64)
    order = np.argsort(-widths, kind="stable")
    counts = [0] * n_shards
    assign = np.empty(n, np.int32)
    heap = [(0.0, s) for s in range(n_shards) if caps[s] > 0]
    heapq.heapify(heap)
    for i in order:
        load, s = heapq.heappop(heap)   # least-loaded shard with room
        assign[i] = s
        counts[s] += 1
        if counts[s] < caps[s]:
            heapq.heappush(heap, (load + float(widths[i]), s))
    perm = np.argsort(assign, kind="stable")
    return db_masks[perm]


def pack_dataset(transactions, n_items: int) -> np.ndarray:
    """Pack to (N, W) uint32 bitmask matrix."""
    return pack_itemsets([list(t) for t in transactions], n_items)
