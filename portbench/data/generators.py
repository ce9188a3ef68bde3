"""Vectorised transaction generators: the benchmark's own copies.

They draw the distributions of the port's ``repro_torch/data/generator.py``
(IBM Quest patterns, and attribute-value rows with Zipf-skewed values) in a
few whole-array numpy calls instead of a Python loop over transactions, so
200,000 rows take about a second of set-up.  The bits differ from the port's
generator; the shape of the data does not.

Every generator returns a ``(n_txns, n_items)`` bool matrix; :func:`pack`
turns it into the ``(n_txns, ceil(n_items / 32))`` uint32 words the port
takes (bit ``i % 32`` of word ``i // 32`` is item ``i``).
"""

from __future__ import annotations

import numpy as np


def ibm_quest(rng: np.random.Generator, n_txns: int, n_items: int,
              avg_width: int, n_patterns: int, avg_pattern_len: float,
              corruption: float) -> np.ndarray:
    """IBM-Quest-style T{avg_width}D{n_txns} transactions.

    Patterns have 1 + Poisson sizes (at least 2) and share items with the
    previous pattern half of the time; their popularity is exponential.  A
    transaction draws a Poisson width and fills it from popular patterns,
    each item dropped with probability ``corruption``, at most 40 patterns;
    it keeps its lowest ``width`` items when it overshoots and tops up with
    uniform noise when it falls short.
    """
    patterns = []
    prev = None
    for _ in range(n_patterns):
        size = max(2, 1 + rng.poisson(avg_pattern_len - 1))
        if prev is not None and prev.size and rng.random() < 0.5:
            n_keep = min(prev.size, max(1, int(rng.random() * size)))
            keep = rng.choice(prev, size=n_keep, replace=False)
        else:
            keep = np.empty(0, np.int64)
        fresh = rng.choice(n_items, size=size, replace=False)
        pat = np.unique(np.concatenate([keep, fresh]))[:size]
        patterns.append(pat)
        prev = pat
    weights = rng.exponential(1.0, n_patterns)
    weights /= weights.sum()
    longest = max(p.size for p in patterns)
    table = np.full((n_patterns, longest), -1, np.int64)
    for i, p in enumerate(patterns):
        table[i, :p.size] = p

    width = np.minimum(np.maximum(rng.poisson(avg_width, n_txns), 1), n_items)
    rows = np.zeros((n_txns, n_items), bool)
    count = np.zeros(n_txns, np.int64)
    cum = np.cumsum(weights)
    active = np.arange(n_txns)
    for _ in range(40):
        if active.size == 0:
            break
        pick = np.minimum(np.searchsorted(cum, rng.random(active.size)),
                          n_patterns - 1)
        items = table[pick]                                  # (a, longest)
        kept = (items >= 0) & (rng.random(items.shape) >= corruption)
        r, c = np.nonzero(kept)
        rows[active[r], items[r, c]] = True
        count[active] = rows[active].sum(axis=1)
        active = active[count[active] < width[active]]
    # overshoot: keep the lowest `width` items of the row
    over = count > width
    if over.any():
        sub = rows[over]
        sub &= np.cumsum(sub, axis=1) <= width[over, None]
        rows[over] = sub
    # shortfall: uniform noise until the row is as wide as drawn
    short = np.nonzero(rows.sum(axis=1) < width)[0]
    while short.size:
        rows[short, rng.integers(0, n_items, short.size)] = True
        short = short[rows[short].sum(axis=1) < width[short]]
    return rows


def attribute_value(rng: np.random.Generator, n_txns: int,
                    value_counts: list, skew: float) -> np.ndarray:
    """One item per (attribute, value); every row takes one value of each
    attribute, value ``v`` (0-based) with probability ∝ 1 / (v + 1)^skew."""
    n_items = int(sum(value_counts))
    rows = np.zeros((n_txns, n_items), bool)
    off = 0
    for vc in value_counts:
        p = 1.0 / np.arange(1, vc + 1) ** skew
        cum = np.cumsum(p / p.sum())
        v = np.minimum(np.searchsorted(cum, rng.random(n_txns)), vc - 1)
        rows[np.arange(n_txns), off + v] = True
        off += vc
    return rows


GENERATORS = {"ibm_quest": ibm_quest, "attribute_value": attribute_value}


def generate(dataset: dict) -> np.ndarray:
    """The configuration's dataset: ``dataset["generator"]`` over its other
    keys, drawn from ``dataset["data_seed"]``, so every run of a
    configuration mines the same rows."""
    params = {k: v for k, v in dataset.items()
              if k not in ("generator", "data_seed")}
    rng = np.random.default_rng(dataset["data_seed"])
    return GENERATORS[dataset["generator"]](rng, **params)


def pack(rows: np.ndarray) -> np.ndarray:
    """(n, n_items) bool → (n, ceil(n_items / 32)) uint32 words."""
    n, n_items = rows.shape
    w = -(-n_items // 32)
    padded = np.zeros((n, 32 * w), bool)
    padded[:, :n_items] = rows
    return np.packbits(padded, axis=1, bitorder="little").view("<u4").astype(
        np.uint32)


def unpack(words: np.ndarray, n_items: int) -> np.ndarray:
    """Inverse of :func:`pack`."""
    bits = np.unpackbits(np.ascontiguousarray(words, "<u4").view(np.uint8),
                         axis=1, bitorder="little")
    return bits[:, :n_items].astype(bool)


def drop_one_queries(rng: np.random.Generator, rows: np.ndarray,
                     n: int) -> list:
    """``n`` baskets: a row drawn uniformly, with one of its items dropped
    (rows of one item are kept whole) — a basket whose missing item the
    rules can fill in.  Returns lists of item ids."""
    picks = rng.integers(0, rows.shape[0], n)
    drop = rng.random(n)
    out = []
    for p, d in zip(picks, drop):
        items = np.nonzero(rows[p])[0].tolist()
        if len(items) > 1:
            items.pop(int(d * len(items)))
        out.append(items)
    return out
