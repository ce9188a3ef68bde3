"""Synthetic transaction datasets.

The paper evaluates on ``c20d10k`` (IBM Quest generator: 10 000 txns, 192 items,
avg width 20), ``chess`` (3 196 txns, 75 items, fixed width 37) and ``mushroom``
(8 124 txns, 119 items, width 23).  The two UCI datasets are not redistributable
offline, so :func:`chess_like` / :func:`mushroom_like` synthesize attribute–value
datasets with the same (N, |I|, w) signature and a similar density profile
(skewed per-attribute value distributions → long frequent itemsets at moderate
min_sup, which is the regime the paper's optimizations target).
"""

from __future__ import annotations

import numpy as np


def ibm_generator(n_txns: int = 10_000, n_items: int = 192, avg_width: int = 20,
                  n_patterns: int = 40, avg_pattern_len: float = 4.0,
                  corruption: float = 0.25, seed: int = 0) -> list[list[int]]:
    """IBM-Quest-style generator (T{avg_width}D{n_txns} over ``n_items`` items).

    Maximal potential itemsets ("patterns") are drawn with exponentially skewed
    popularity; each transaction fills its Poisson-sized width from patterns,
    dropping items with ``corruption`` probability, topping up with noise.
    """
    rng = np.random.default_rng(seed)
    # patterns: sizes ~ 1 + Poisson, items share overlap with the previous one
    patterns = []
    prev: np.ndarray | None = None
    for _ in range(n_patterns):
        size = max(2, 1 + rng.poisson(avg_pattern_len - 1))
        if prev is not None and prev.size and rng.random() < 0.5:
            n_keep = min(prev.size, max(1, int(rng.random() * size)))
            keep = rng.choice(prev, size=n_keep, replace=False)
        else:
            keep = np.empty(0, dtype=np.int64)
        fresh = rng.choice(n_items, size=size, replace=False)
        pat = np.unique(np.concatenate([keep, fresh]))[:size]
        patterns.append(pat)
        prev = pat
    weights = rng.exponential(1.0, n_patterns)
    weights /= weights.sum()

    txns = []
    for _ in range(n_txns):
        width = max(1, rng.poisson(avg_width))
        items: set[int] = set()
        guard = 0
        while len(items) < width and guard < 40:
            guard += 1
            pat = patterns[rng.choice(n_patterns, p=weights)]
            kept = pat[rng.random(pat.size) >= corruption]
            items.update(int(i) for i in kept)
        if len(items) > width:
            items = set(list(items)[:width])
        while len(items) < width:  # top up with uniform noise
            items.add(int(rng.integers(n_items)))
        txns.append(sorted(items))
    return txns


def _attribute_value_dataset(n_txns: int, value_counts: list[int],
                             skew: float, seed: int) -> tuple[list[list[int]], int]:
    """One item per (attribute, value); each txn takes one value per attribute.

    ``skew`` is the Zipf-ish exponent of the per-attribute value distribution —
    higher skew → denser dataset → longer frequent itemsets.
    """
    rng = np.random.default_rng(seed)
    offsets = np.concatenate([[0], np.cumsum(value_counts)])[:-1]
    txns = []
    probs = []
    for vc in value_counts:
        p = 1.0 / np.arange(1, vc + 1) ** skew
        probs.append(p / p.sum())
    for _ in range(n_txns):
        row = [int(off + rng.choice(vc, p=p))
               for off, vc, p in zip(offsets, value_counts, probs)]
        txns.append(sorted(row))
    return txns, int(sum(value_counts))


def chess_like(n_txns: int = 3196, seed: int = 0) -> tuple[list[list[int]], int]:
    """chess stand-in: 37 attributes / 75 items / width exactly 37 (dense)."""
    # 36 binary-ish attributes + one multi-valued (real chess: 36 features + class)
    value_counts = [2] * 35 + [3, 2]  # 35*2 + 3 + 2 = 75 items, 37 attributes
    return _attribute_value_dataset(n_txns, value_counts, skew=2.2, seed=seed)


def mushroom_like(n_txns: int = 8124, seed: int = 0) -> tuple[list[list[int]], int]:
    """mushroom stand-in: 23 attributes / 119 items / width exactly 23."""
    # 22 attributes with 2–10 values + class(2): 23 attributes, 119 items
    value_counts = [2, 6, 4, 10, 2, 9, 4, 3, 10, 2, 5, 4, 4, 9, 9, 4, 3, 5, 9, 6, 5, 2]
    assert sum(value_counts) == 119 - 2
    value_counts = value_counts + [2]
    return _attribute_value_dataset(n_txns, value_counts, skew=1.8, seed=seed)


def dataset_by_name(name: str, seed: int = 0, scale: float = 1.0):
    """Named datasets used across benchmarks. Returns (transactions, n_items)."""
    if name == "c20d10k":
        n = int(10_000 * scale)
        return ibm_generator(n_txns=n, n_items=192, avg_width=20, seed=seed), 192
    if name == "c20d200k":  # the paper's speedup dataset (c20d10k × 20)
        n = int(200_000 * scale)
        return ibm_generator(n_txns=n, n_items=192, avg_width=20, seed=seed), 192
    if name == "chess":
        t, n_items = chess_like(n_txns=int(3196 * scale), seed=seed)
        return t, n_items
    if name == "mushroom":
        t, n_items = mushroom_like(n_txns=int(8124 * scale), seed=seed)
        return t, n_items
    raise ValueError(f"unknown dataset {name!r}")
