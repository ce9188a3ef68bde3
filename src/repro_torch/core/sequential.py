"""Pure-Python sequential Apriori — the ground-truth oracle for all tests.

Deliberately simple (tuples + dict counting), independent from the bitmask and
MapReduce paths so that agreement between the two is meaningful evidence.
"""

from __future__ import annotations

from itertools import combinations


def sequential_apriori(transactions, min_sup: float):
    """Mine frequent itemsets.

    Args:
      transactions: iterable of iterables of item ids.
      min_sup: fractional minimum support in (0, 1].

    Returns:
      dict ``k -> {itemset_tuple: count}`` with itemsets as sorted tuples.
    """
    txns = [frozenset(t) for t in transactions]
    n = len(txns)
    min_count = min_sup * n

    counts1: dict[tuple[int, ...], int] = {}
    for t in txns:
        for it in t:
            counts1[(it,)] = counts1.get((it,), 0) + 1
    levels = {1: {s: c for s, c in counts1.items() if c >= min_count}}

    k = 2
    while levels[k - 1]:
        prev = sorted(levels[k - 1])
        prev_set = set(prev)
        # classic join: equal (k-2)-prefix, differing last item
        cands = []
        for i in range(len(prev)):
            for j in range(i + 1, len(prev)):
                a, b = prev[i], prev[j]
                if a[:-1] == b[:-1]:
                    cand = a + (b[-1],) if a[-1] < b[-1] else b + (a[-1],)
                    # prune: every (k-1)-subset must be frequent
                    if all(sub in prev_set for sub in combinations(cand, k - 1)):
                        cands.append(cand)
        counts = {c: 0 for c in cands}
        cand_sets = [(c, frozenset(c)) for c in cands]
        for t in txns:
            for c, cs in cand_sets:
                if cs <= t:
                    counts[c] += 1
        levels[k] = {c: v for c, v in counts.items() if v >= min_count}
        k += 1
    if not levels[max(levels)]:
        del levels[max(levels)]
    return levels
