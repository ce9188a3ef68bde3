"""Running per-level candidate count tables for incremental mining
(DESIGN.md §8) — the port's copy of the JAX package's ``stream/tables.py``
(numpy only).

After a full mine over the window, the tracked tables hold — per Apriori
level — a *superset* of the candidate set a from-scratch run would count,
with exact support counts: ``C_1`` = all singletons and ``C_{k+1}`` =
``apriori_gen(E_k)`` where ``E_k`` is the **margin-expanded** frequent set
``{c ∈ C_k : count ≥ (1 − margin)·min_count}``.  Frequent counts come from
the mining result; the *negative border* (tracked but infrequent) is counted
by one extra MapReduce job per level during the build.  The margin buys
headroom: a border itemset that drifts *above* threshold between re-mines
already has its supersets tracked, so near-threshold churn stays on the
O(delta) path instead of forcing a structural re-mine.  Between re-mines,
every window update adjusts all tracked counts with one O(delta) signed
counting dispatch (``kernels/delta_count.py``).

Exactness argument (:func:`derive_frequent`): the frequent levels of a
from-scratch mine are determined solely by the counts of the candidates it
generates.  Walking levels with the *current* counts, the cascade regenerates
``needed = apriori_gen(L'_{k-1})`` from the current frequent sets; whenever
every needed candidate is tracked, its exact count is known and the derived
levels are byte-identical to a from-scratch mine of the current window (both
arrays are the canonically lexsorted generation order filtered by the same
threshold).  A needed candidate that is *not* tracked — possible once a
border itemset drifts above threshold — means an unknown count: the cascade
reports structural drift and the miner falls back to a full re-mine, which is
always available and doubles as the equivalence oracle.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.bitset import MaskIndex, singleton_masks
from repro_torch.core.candidates import apriori_gen
from repro_torch.core.phases import bucket_pad


@dataclasses.dataclass
class _Level:
    masks: np.ndarray        # (C, W) uint32 tracked candidates, canonical order
    counts: np.ndarray       # (C,) int64 exact supports over the window
    index: MaskIndex         # exact membership/lookup over ``masks``


class TrackedTables:
    """Per-level tracked candidates + running counts + one packed view.

    ``cat_padded`` is the bucket-padded concatenation of every tracked level
    (built once per re-mine) — the O(delta) counting dispatch runs over it and
    :meth:`apply_delta` scatters the signed deltas back per level.
    """

    def __init__(self, levels: dict):
        self.levels = {k: _Level(np.asarray(m, np.uint32),
                                 np.asarray(c, np.int64).copy(),
                                 MaskIndex(np.asarray(m, np.uint32)))
                       for k, (m, c) in sorted(levels.items())}
        parts = [lv.masks for lv in self.levels.values()]
        self.n_tracked = int(sum(p.shape[0] for p in parts))
        if parts:
            cat = np.concatenate(parts, axis=0)
            self.cat_padded = bucket_pad(cat)
        else:
            self.cat_padded = None

    @property
    def depth(self) -> int:
        return max(self.levels) if self.levels else 0

    def apply_delta(self, deltas: np.ndarray) -> None:
        """Scatter one (n_tracked,) signed delta vector into the per-level
        int64 running counts."""
        off = 0
        for lv in self.levels.values():
            n = lv.masks.shape[0]
            lv.counts += deltas[off:off + n].astype(np.int64)
            off += n
        assert off == self.n_tracked, (off, self.n_tracked)


def derive_frequent(tables: TrackedTables, min_count: float):
    """Derive the exact frequent levels of the current window from tracked
    counts, or return ``None`` on structural drift (unknown candidate needed).

    Returns the same shape as ``MiningResult.levels``: ``{k: (masks, counts)}``
    with empty levels dropped — byte-identical to a from-scratch ``mine()``
    on the window contents whenever it returns non-None.
    """
    if 1 not in tables.levels:
        return {}
    levels: dict = {}
    lv1 = tables.levels[1]
    keep = lv1.counts >= min_count
    L = lv1.masks[keep]
    if keep.any():
        levels[1] = (L, lv1.counts[keep])
    k = 2
    while L.shape[0] > 0:
        needed = apriori_gen(L, k - 1)
        if needed.shape[0] == 0:
            break
        lv = tables.levels.get(k)
        if lv is None:
            return None                       # deeper than anything tracked
        idx = lv.index.find(needed)
        if (idx < 0).any():
            return None                       # untracked candidate → re-mine
        counts = lv.counts[idx]
        keep = counts >= min_count
        L = needed[keep]
        if keep.any():
            levels[k] = (L, counts[keep])
        k += 1
    return levels


def build_tracked_levels(result_levels: dict, n_items: int, min_count: float,
                         margin: float, count_fn) -> dict:
    """Enumerate + count the tracked candidate sets after a full mine.

    Levels are built top-down: known counts are looked up from the mine's
    frequent levels, the per-level border is counted with ``count_fn(masks) →
    counts`` (one unfused MapReduce job per level), and the next level is
    generated from the margin-expanded set ``E_k`` (count ≥
    ``(1 − margin)·min_count``).  Since ``L'_k ⊆ E_k`` for any later frequent
    set that only churns within the margin, ``apriori_gen(L'_k) ⊆
    apriori_gen(E_k)`` (join of a subset is a subset; pruning against the
    smaller set is stricter) — which is exactly the cascade's coverage
    requirement.

    Returns ``{k: (masks, counts)}`` with exact counts everywhere.
    """
    tracked: dict = {}
    ext = max(0.0, (1.0 - margin)) * min_count
    k = 1
    cands = singleton_masks(n_items)
    while cands.shape[0]:
        counts = np.full(cands.shape[0], -1, np.int64)
        entry = result_levels.get(k)
        if entry is not None and np.asarray(entry[0]).shape[0] > 0:
            fmasks = np.asarray(entry[0], np.uint32)
            fcounts = np.asarray(entry[1], np.int64)
            idx = MaskIndex(fmasks).find(cands)
            counts[idx >= 0] = fcounts[idx[idx >= 0]]
        miss = counts < 0
        if miss.any():
            counts[miss] = np.asarray(count_fn(cands[miss]), np.int64)
        tracked[k] = (cands, counts)
        expanded = cands[counts >= ext]
        if expanded.shape[0] == 0:
            break
        cands = apriori_gen(expanded, k)
        k += 1
    return tracked


def levels_equal(a: dict, b: dict) -> bool:
    """Exact equality of two ``{k: (masks, counts)}`` level dicts."""
    if set(a) != set(b):
        return False
    for k in a:
        if not (np.array_equal(a[k][0], b[k][0])
                and np.array_equal(a[k][1], b[k][1])):
            return False
    return True
