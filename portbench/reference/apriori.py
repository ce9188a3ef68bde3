"""Plain level-wise Apriori in numpy: the reference for every mine.

Support counts are popcounts of AND-ed vertical bitmaps; candidates are the
classic prefix join of the previous level with full subset pruning.  It
imports nothing of the port and uses nothing the port made: it reads the
same packed rows the benchmark hands the port.

Levels come back as ``{k: (itemsets (n, k) int64 sorted rows, counts (n,)
int64)}``, ordered by the itemsets' bitmask value (word ``W - 1`` most
significant), which is the lexicographic order of the reversed item tuples.
"""

from __future__ import annotations

import numpy as np

if hasattr(np, "bitwise_count"):
    def _popcount_rows(words: np.ndarray) -> np.ndarray:
        return np.bitwise_count(words).sum(axis=1, dtype=np.int64)
else:                                    # numpy < 2.0
    _BYTE_POP = np.array([bin(i).count("1") for i in range(256)], np.int64)

    def _popcount_rows(words: np.ndarray) -> np.ndarray:
        b = np.ascontiguousarray(words).view(np.uint8)
        return _BYTE_POP[b].sum(axis=1)


def vertical(rows: np.ndarray) -> np.ndarray:
    """(T, I) bool → (I, ceil(T / 64)) uint64 bitmaps, one an item."""
    T, n_items = rows.shape
    tw = -(-T // 64)
    padded = np.zeros((n_items, 64 * tw), bool)
    padded[:, :T] = rows.T
    return np.packbits(padded, axis=1, bitorder="little").view("<u8")


def _join(prev: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Candidates of size k from the frequent (k-1)-itemsets ``prev``
    (sorted rows in lexicographic order): pairs sharing their first k-2
    items, every (k-1)-subset frequent.  Returns ``(cands (n, k), parent
    (n,))`` where ``parent`` is the row of ``prev`` the candidate extends."""
    rows = [tuple(r) for r in prev.tolist()]
    frequent = set(rows)
    km1 = prev.shape[1]
    out, parent = [], []
    start, n = 0, len(rows)
    while start < n:
        end = start + 1
        while end < n and rows[end][:-1] == rows[start][:-1]:
            end += 1
        for i in range(start, end):
            for j in range(i + 1, end):
                cand = rows[i] + (rows[j][-1],)
                if all(cand[:d] + cand[d + 1:] in frequent
                       for d in range(km1 - 1)):
                    out.append(cand)
                    parent.append(i)
        start = end
    if not out:
        return np.zeros((0, km1 + 1), np.int64), np.zeros(0, np.int64)
    return np.array(out, np.int64), np.array(parent, np.int64)


def apriori(rows: np.ndarray, min_sup: float, count_dtype=None,
            block: int = 1024) -> dict:
    """Every itemset with support count ``>= min_sup * T`` and its count.

    ``count_dtype`` (the control's knob) rounds every support count to that
    floating type before the threshold, as a counter held in a lower
    precision would; None keeps the exact integers.
    """
    T, n_items = rows.shape
    min_count = min_sup * T
    v = vertical(rows)

    def rounded(c: np.ndarray) -> np.ndarray:
        if count_dtype is None:
            return c
        with np.errstate(over="ignore"):          # saturates to inf
            return c.astype(count_dtype).astype(np.float64)

    counts = rounded(_popcount_rows(v))
    keep = np.nonzero(counts >= min_count)[0]
    levels = {}
    cur = keep[:, None].astype(np.int64)
    bitmaps = v[keep]
    levels[1] = (cur, counts[keep])
    k = 1
    while cur.shape[0] > 1:
        cands, parent = _join(cur)
        if cands.shape[0] == 0:
            break
        c_counts = np.empty(cands.shape[0])
        c_maps = np.empty((cands.shape[0], v.shape[1]), np.uint64)
        for s in range(0, cands.shape[0], block):
            m = bitmaps[parent[s:s + block]] & v[cands[s:s + block, -1]]
            c_maps[s:s + block] = m
            c_counts[s:s + block] = _popcount_rows(m)
        c_counts = rounded(c_counts)
        keep = c_counts >= min_count
        cur, bitmaps = cands[keep], c_maps[keep]
        k += 1
        if cur.shape[0] == 0:
            break
        levels[k] = (cur, c_counts[keep])
    out = {}
    for k, (its, cnt) in levels.items():
        order = np.lexsort(its.T)            # last item most significant
        out[k] = (its[order], cnt[order])
    return out


def pack_itemsets(itemsets: np.ndarray, n_items: int) -> np.ndarray:
    """(n, k) item ids → (n, ceil(n_items / 32)) uint32 masks."""
    n = itemsets.shape[0]
    words = np.zeros((n, -(-n_items // 32)), np.uint32)
    for col in itemsets.T:
        np.bitwise_or.at(words, (np.arange(n), col // 32),
                         (np.uint32(1) << (col % 32).astype(np.uint32)))
    return words


def canonical(levels: dict) -> dict:
    """``{k: (masks, counts)}`` with rows sorted by mask value, counts as
    int64 — the form two results are compared in."""
    out = {}
    for k, (masks, counts) in levels.items():
        masks = np.asarray(masks, np.uint32)
        if masks.shape[0] == 0:
            continue
        order = np.lexsort(masks.T)
        with np.errstate(invalid="ignore"):       # a saturated control count
            counts = np.asarray(counts).astype(np.int64)
        out[k] = (masks[order], counts[order])
    return out


def mismatches(got: dict, want: dict) -> int:
    """Itemsets missing, extra or with another count, between two
    canonical results."""
    wrong = 0
    for k in set(got) | set(want):
        g = got.get(k)
        w = want.get(k)
        if (g is not None and w is not None and g[0].shape == w[0].shape
                and np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])):
            continue
        gt = ({} if g is None else
              dict(zip(map(bytes, g[0]), g[1].tolist())))
        wt = ({} if w is None else
              dict(zip(map(bytes, w[0]), w[1].tolist())))
        wrong += sum(1 for key in set(gt) | set(wt)
                     if gt.get(key) != wt.get(key))
    return wrong
