"""Vectorized association-rule generation from mined frequent itemsets (the
port of the JAX package's ``core/rules.py``).

Apriori is "the basic algorithm of Association Rule Mining" (paper §1); this
layer completes the pipeline: frequent itemsets → rules  A ⇒ B  with
confidence = sup(A∪B)/sup(A), lift = conf / (sup(B)/N) and leverage =
sup(A∪B)/N − sup(A)·sup(B)/N².

Every antecedent/consequent split of a mined level is enumerated at once as
bit-packed ``(R, W)`` uint32 arrays on the host (numpy, as in the
reference), supports are looked up from the level tables with the sorted-hash
probe of ``bitset.MaskIndex``, and confidence/lift/leverage for all rules
are computed in one torch pass on the given device (DESIGN.md §7).

The array product is a :class:`RuleSet` — antecedent masks, consequent masks
and metric vectors in rank order — which is exactly what the serving layer
(``serving/rules_engine.py``) loads onto the device.  :func:`generate_rules`
keeps the decoded view (a list of :class:`Rule` tuples); its float64
metrics are derived from the stored integer counts.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .bitset import MaskIndex, WORD_BITS, n_words, unpack_itemsets
from .drivers import MiningResult
from .mapreduce import resolve_device

# Split enumeration is O(2^k) per level-k itemset; frequent itemsets beyond
# this length indicate a degenerate min_sup rather than a real workload.
MAX_RULE_K = 22


@dataclasses.dataclass(frozen=True)
class Rule:
    antecedent: tuple
    consequent: tuple
    support: float          # fractional support of A∪B
    confidence: float
    lift: float
    leverage: float = 0.0   # sup(A∪B)/N − sup(A)·sup(B)/N²

    def __str__(self):
        a = ",".join(map(str, self.antecedent))
        c = ",".join(map(str, self.consequent))
        return (f"{{{a}}} => {{{c}}} "
                f"(sup={self.support:.3f} conf={self.confidence:.3f} "
                f"lift={self.lift:.2f})")


@dataclasses.dataclass
class RuleSet:
    """Bit-packed, rank-ordered rule arrays — the device-side rule format.

    Rules are sorted by (confidence, lift) descending.  ``confidence``,
    ``lift``, ``leverage`` and ``score`` are the float32 outputs of the
    device metric pass; the integer count columns are kept so exact float64
    metrics can be re-derived on host (``to_rules``).
    """

    n_items: int
    n_txns: int
    ante_masks: np.ndarray      # (R, W) uint32 antecedent bitmasks
    cons_masks: np.ndarray      # (R, W) uint32 consequent bitmasks
    union_counts: np.ndarray    # (R,) int64  sup(A∪B)
    ante_counts: np.ndarray     # (R,) int64  sup(A)
    cons_counts: np.ndarray     # (R,) int64  sup(B)
    confidence: np.ndarray      # (R,) float32
    lift: np.ndarray            # (R,) float32
    leverage: np.ndarray        # (R,) float32
    score: np.ndarray           # (R,) float32 confidence·lift — serving rank key

    @classmethod
    def from_arrays(cls, n_items, n_txns, ante_masks, cons_masks,
                    union_counts, ante_counts, cons_counts, confidence, lift,
                    leverage, score) -> "RuleSet":
        """A RuleSet from plain arrays — e.g. the fields of the JAX
        package's RuleSet — with each column in this class's dtype."""
        u32 = functools.partial(np.asarray, dtype=np.uint32)
        i64 = functools.partial(np.asarray, dtype=np.int64)
        f32 = functools.partial(np.asarray, dtype=np.float32)
        return cls(int(n_items), int(n_txns), u32(ante_masks),
                   u32(cons_masks), i64(union_counts), i64(ante_counts),
                   i64(cons_counts), f32(confidence), f32(lift),
                   f32(leverage), f32(score))

    def __len__(self) -> int:
        return self.ante_masks.shape[0]

    def exact_metrics(self):
        """Float64 (support, confidence, lift, leverage) from the int counts."""
        n = float(self.n_txns)
        u = self.union_counts.astype(np.float64)
        a = self.ante_counts.astype(np.float64)
        c = self.cons_counts.astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            conf = np.where(a > 0, u / a, 0.0)
            lift = np.where(c > 0, conf * n / c, np.inf)
            lev = u / n - (a / n) * (c / n)
        return u / n, conf, lift, lev

    def to_rules(self, max_rules: int | None = None) -> list[Rule]:
        """Host decode: sorted tuples + exact float64 metrics per rule."""
        r = len(self) if max_rules is None else min(max_rules, len(self))
        sup, conf, lift, lev = self.exact_metrics()
        antes = unpack_itemsets(self.ante_masks[:r])
        conss = unpack_itemsets(self.cons_masks[:r])
        return [Rule(antes[i], conss[i], float(sup[i]), float(conf[i]),
                     float(lift[i]), float(lev[i])) for i in range(r)]


# ---------------------------------------------------------------------------
# Split enumeration (vectorized over itemsets × splits).
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _split_table(k: int):
    """All 2^k − 2 nonempty proper antecedent patterns of a k-itemset.

    Returns ``(splits (S, k) bool, sizes (S,) int64)``; cached per k — callers
    must treat the arrays as read-only.
    """
    s = np.arange(1, (1 << k) - 1, dtype=np.uint32)
    bits = ((s[:, None] >> np.arange(k, dtype=np.uint32)[None, :]) & 1).astype(bool)
    return bits, bits.sum(axis=1).astype(np.int64)


def _item_table(masks: np.ndarray, k: int) -> np.ndarray:
    """(N, W) level-k masks → (N, k) int32 sorted item ids per row."""
    N, W = masks.shape
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    bits = ((masks[:, :, None] >> shifts[None, None, :]) & np.uint32(1))
    bits = bits.reshape(N, W * WORD_BITS).astype(bool)
    _, cols = np.nonzero(bits)
    return cols.reshape(N, k).astype(np.int32)


def _iter_splits(masks: np.ndarray, k: int, chunk_words: int = 1 << 22):
    """Enumerate every antecedent of every level-k itemset, bit-packed, in
    bounded chunks.

    Yields ``(ante (n·S, W) uint32, parent (n·S,) intp, a_size (n·S,) int64)``
    with S = 2^k − 2 and ``n`` itemsets per chunk, sized so the
    (chunk, S, k, W) broadcast intermediate stays near ``chunk_words`` words —
    the caller filters each chunk before the next is built, so peak memory
    never scales with the full N·S rule count of a level.
    """
    N, W = masks.shape
    splits, sizes = _split_table(k)
    S = splits.shape[0]
    items = _item_table(masks, k)
    # per-item singleton masks (N, k, W)
    im = np.zeros((N, k, W), np.uint32)
    ridx = np.arange(N)[:, None]
    cidx = np.arange(k)[None, :]
    im[ridx, cidx, items >> 5] = (1 << (items & 31)).astype(np.uint32)

    step = max(1, chunk_words // max(S * k * W, 1))
    for i in range(0, N, step):
        blk = im[i:i + step]                              # (n, k, W)
        sel = np.where(splits[None, :, :, None], blk[:, None, :, :],
                       np.uint32(0))                      # (n, S, k, W)
        ante = np.bitwise_or.reduce(sel, axis=2).reshape(-1, W)
        parent = np.repeat(np.arange(i, i + blk.shape[0]), S)
        yield ante, parent, np.tile(sizes, blk.shape[0])


# ---------------------------------------------------------------------------
# Support lookup: sorted-hash count tables over the mined levels.
# ---------------------------------------------------------------------------

class _CountTables:
    """Lazy per-size (MaskIndex, counts) tables from result.levels."""

    def __init__(self, levels: dict):
        self._levels = levels
        self._cache: dict = {}

    def get(self, size: int):
        if size not in self._cache:
            entry = self._levels.get(size)
            if entry is None or np.asarray(entry[0]).shape[0] == 0:
                self._cache[size] = None
            else:
                self._cache[size] = (MaskIndex(np.asarray(entry[0], np.uint32)),
                                     np.asarray(entry[1], np.int64))
        return self._cache[size]


def _lookup_counts(table, queries: np.ndarray):
    """Vectorized exact count lookup → ``(counts (Q,) int64, found (Q,) bool)``
    via :meth:`bitset.MaskIndex.find`."""
    if table is None or queries.shape[0] == 0:
        return (np.zeros(queries.shape[0], np.int64),
                np.zeros(queries.shape[0], bool))
    index, counts = table
    idx = index.find(queries)
    found = idx >= 0
    return np.where(found, counts[np.maximum(idx, 0)], 0), found


# ---------------------------------------------------------------------------
# Device metric pass.
# ---------------------------------------------------------------------------

def _rule_metrics(union: np.ndarray, ante: np.ndarray, cons: np.ndarray,
                  n_txns: int, device: torch.device):
    """One float32 pass on ``device``: confidence, lift, leverage and score
    for all rules, returned as host arrays.

    The operations and their order are the reference's (``rules.py:199-209``),
    so every float32 result has the same bits.
    """
    u, a, c = (torch.from_numpy(np.asarray(x, np.int64)).to(device)
               .to(torch.float32) for x in (union, ante, cons))
    n = torch.tensor(float(n_txns), dtype=torch.float32, device=device)
    conf = u / a
    lift = conf * (n / c)          # c == 0 (missing consequent) → inf
    # XLA contracts the reference's `u/n - (a/n)*(c/n)` into one fused
    # multiply-add, rounding once; the same expression evaluated step by step
    # in float32 differs from it in the last bit on most rules.  The product
    # of two float32 values is exact in float64, so the difference taken in
    # float64 and rounded to float32 gives the fused result's bits.
    un, an, cn = u / n, a / n, c / n
    lev = (un.double() - an.double() * cn.double()).to(torch.float32)
    score = conf * lift
    return tuple(t.cpu().numpy() for t in (conf, lift, lev, score))


def _empty_ruleset(result: MiningResult) -> RuleSet:
    W = n_words(result.n_items)
    z = np.zeros((0,), np.int64)
    f = np.zeros((0,), np.float32)
    return RuleSet(result.n_items, result.n_txns,
                   np.zeros((0, W), np.uint32), np.zeros((0, W), np.uint32),
                   z, z.copy(), z.copy(), f, f.copy(), f.copy(), f.copy())


def generate_ruleset(result: MiningResult, min_confidence: float = 0.6,
                     device="cuda") -> RuleSet:
    """All rules A ⇒ B (A, B nonempty, disjoint, A∪B frequent) meeting
    ``min_confidence``, as a rank-ordered :class:`RuleSet`.

    The confidence threshold is applied with the exact float64 semantics of
    the sequential oracle (``conf + 1e-12 >= min_confidence``) from the integer
    support counts; the float32 metric vectors come from one torch pass over
    the surviving rules on ``device`` ("cuda", the default, raises without a
    card; "cpu" runs the same pass on the host).
    """
    device = resolve_device(device)
    tables = _CountTables(result.levels)
    parts: list[tuple] = []

    for k in sorted(result.levels):
        masks, counts = result.levels[k]
        masks = np.asarray(masks, np.uint32)
        counts = np.asarray(counts, np.int64)
        if k < 2 or masks.shape[0] == 0:
            continue
        if k > MAX_RULE_K:
            raise ValueError(
                f"level {k} exceeds MAX_RULE_K={MAX_RULE_K}: "
                f"2^{k} splits per itemset is not a sane rule workload")
        for ante, parent, a_size in _iter_splits(masks, k):
            cons = masks[parent] & ~ante
            union_c = counts[parent]
            a_c = np.zeros(ante.shape[0], np.int64)
            c_c = np.zeros(ante.shape[0], np.int64)
            found = np.zeros(ante.shape[0], bool)
            for a in range(1, k):
                sel = a_size == a
                if not sel.any():
                    continue
                ac, fa = _lookup_counts(tables.get(a), ante[sel])
                cc, _ = _lookup_counts(tables.get(k - a), cons[sel])
                a_c[sel] = ac
                c_c[sel] = cc      # 0 when missing → lift = inf (legacy)
                found[sel] = fa    # antecedent support is required
            ok = found & (a_c > 0)
            with np.errstate(divide="ignore", invalid="ignore"):
                conf = np.where(ok, union_c / np.where(a_c > 0, a_c, 1), 0.0)
            keep = ok & (conf + 1e-12 >= min_confidence)
            if keep.any():
                parts.append((ante[keep], cons[keep], union_c[keep],
                              a_c[keep], c_c[keep]))

    if not parts:
        return _empty_ruleset(result)

    ante = np.concatenate([p[0] for p in parts], axis=0)
    cons = np.concatenate([p[1] for p in parts], axis=0)
    union_c = np.concatenate([p[2] for p in parts])
    a_c = np.concatenate([p[3] for p in parts])
    c_c = np.concatenate([p[4] for p in parts])

    n = float(result.n_txns)
    conf64 = union_c / a_c
    with np.errstate(divide="ignore"):
        lift64 = np.where(c_c > 0, conf64 * n / np.where(c_c > 0, c_c, 1),
                          np.inf)
    order = np.lexsort((-lift64, -conf64))
    ante, cons = ante[order], cons[order]
    union_c, a_c, c_c = union_c[order], a_c[order], c_c[order]

    conf, lift, lev, score = _rule_metrics(union_c, a_c, c_c,
                                           result.n_txns, device)
    return RuleSet(result.n_items, result.n_txns, ante, cons,
                   union_c, a_c, c_c, conf, lift, lev, score)


def generate_rules(result: MiningResult, min_confidence: float = 0.6,
                   max_rules: int | None = None, device="cuda") -> list[Rule]:
    """Decoded view of :func:`generate_ruleset`: rules sorted by
    (confidence, lift) descending with exact float64 metrics."""
    return generate_ruleset(result, min_confidence, device).to_rules(max_rules)
