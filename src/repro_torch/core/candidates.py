"""Candidate generation: ``apriori_gen`` (join + prune) and ``non_apriori_gen`` (join only).

Semantics match the classic Agrawal–Srikant generation exactly:

* **join** — two size-``k`` itemsets join iff they share their ``k-1`` *lowest*
  items (the sorted-order prefix) and differ in the highest one.  With bitmasks
  that is: ``popcount(a | b) == k + 1`` and ``highest_bit(a & b) < lowest_bit(a ^ b)``.
  Each ``(k+1)``-candidate is produced by exactly one unordered pair, so no
  dedup pass is needed and candidate counts are comparable to the paper's.
* **prune** — drop a candidate if any of its ``k``-subsets is absent from the
  previous level (the Apriori property).  ``non_apriori_gen`` skips this — the
  paper's §4.2 optimization — producing a superset of un-pruned candidates whose
  false positives are eliminated by support counting (integrity preserved).

Generation is host-side vectorized numpy (the Hadoop analogue is the in-mapper
trie construction; see DESIGN.md §2 for why this lives on the host in the TPU
adaptation).  The heavy phase — support counting over the transaction shards —
is the device path in :mod:`repro_torch.core.counting`.

``speculative_join`` supports the async phase pipeline (DESIGN.md §4): while a
counting job is in flight, the *next* phase's join is computed over the current
level's un-filtered candidates with parent bookkeeping, so that once the keep
mask arrives the exact ``join(L)`` is recovered by pair filtering instead of a
fresh O(|L|²) pass.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.obs.trace import current_tracer

from .bitset import WORD_BITS, MaskIndex, highest_bit_index, lowest_bit_index

_DEF_BLOCK = 1024


def _bit_matrix(masks: np.ndarray) -> np.ndarray:
    """(N, W) uint32 → (N, W*32) uint8 bit expansion (bit b of word w at w*32+b)."""
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    bits = (masks[:, :, None] >> shifts[None, None, :]) & np.uint32(1)
    return bits.reshape(masks.shape[0], -1).astype(np.uint8)


def _join_pairs_prefix(prev: np.ndarray):
    """Prefix-grouped join: O(output) instead of O(n²) pair tests.

    Two size-``k`` itemsets join iff they share their ``k-1`` lowest items —
    i.e. iff they are identical after clearing the highest bit.  Grouping rows
    by that prefix (the flat-array analogue of walking the paper's trie level)
    means *every* in-group pair joins and no cross-group pair does, so the
    join is exact pair enumeration over the groups (§Perf iteration M-E).
    """
    prev = np.asarray(prev, dtype=np.uint32)
    n, W = prev.shape
    hi = highest_bit_index(prev)                   # (n,) ; -1 for empty rows
    prefix = prev.copy()
    valid = hi >= 0
    rows = np.nonzero(valid)[0]
    prefix[rows, hi[valid] // WORD_BITS] ^= (
        np.uint32(1) << (hi[valid] % WORD_BITS).astype(np.uint32))
    _, group_ids = np.unique(prefix, axis=0, return_inverse=True)
    order = np.argsort(group_ids, kind="stable")   # rows grouped, stable
    sizes = np.bincount(group_ids)
    starts = np.zeros(sizes.size + 1, np.int64)
    np.cumsum(sizes, out=starts[1:])
    left_parts, right_parts = [], []
    for s in np.unique(sizes):
        if s < 2:
            continue
        g_starts = starts[:-1][sizes == s]         # (G,) groups of this size
        p, q = np.triu_indices(int(s), k=1)        # local pair indices
        left_parts.append((g_starts[:, None] + p[None, :]).ravel())
        right_parts.append((g_starts[:, None] + q[None, :]).ravel())
    if not left_parts:
        return (np.zeros((0, W), dtype=np.uint32),
                np.zeros(0, np.int64), np.zeros(0, np.int64))
    left = order[np.concatenate(left_parts)]       # back to original row ids
    right = order[np.concatenate(right_parts)]
    cands = prev[left] | prev[right]
    order_out = np.lexsort(tuple(cands[:, wi] for wi in range(W)))
    return cands[order_out], left[order_out], right[order_out]


def join_pairs(prev: np.ndarray, k_prev: int, block: int = _DEF_BLOCK,
               method: str = "prefix"):
    """Classic Apriori join with parent bookkeeping.

    Returns ``(cands, left, right)`` where ``cands[i] = prev[left[i]] |
    prev[right[i]]``.  ``cands`` is canonically ordered (lexicographic by
    words, high word first).  ``method="prefix"`` (default) enumerates pairs
    within shared-(k-1)-prefix groups — O(output) work; ``method="pairwise"``
    is the legacy blocked all-pairs evaluation (peak memory ``O(block² · W)``),
    kept as the pre-pipeline baseline for A/B benchmarks.  Both produce
    byte-identical results.
    """
    prev = np.asarray(prev, dtype=np.uint32)
    n, W = prev.shape
    empty = (np.zeros((0, W), dtype=np.uint32),
             np.zeros(0, np.int64), np.zeros(0, np.int64))
    if n < 2:
        return empty
    if method == "prefix":
        return _join_pairs_prefix(prev)
    out_blocks, left_blocks, right_blocks = [], [], []
    for bi in range(0, n, block):
        a = prev[bi:bi + block]
        for bj in range(bi, n, block):
            b = prev[bj:bj + block]
            diff = a[:, None, :] ^ b[None, :, :]
            pc_diff = np.bitwise_count(diff).sum(-1)
            cand_pair = pc_diff == 2  # share exactly k_prev-1 items
            if bi == bj:  # only strict upper triangle on the diagonal block
                cand_pair &= np.triu(np.ones(cand_pair.shape, dtype=bool), k=1)
            ii, jj = np.nonzero(cand_pair)
            if ii.size == 0:
                continue
            # §Perf iteration M-B: evaluate the prefix condition only on the
            # ~O(n·deg) surviving pairs instead of the full O(block²) tile.
            ai, bj_rows = a[ii], b[jj]
            hi = highest_bit_index(ai & bj_rows)
            lo_d = lowest_bit_index(ai ^ bj_rows)
            keep = hi < lo_d
            if keep.any():
                out_blocks.append(ai[keep] | bj_rows[keep])
                left_blocks.append(bi + ii[keep])
                right_blocks.append(bj + jj[keep])
    if not out_blocks:
        return empty
    cands = np.concatenate(out_blocks, axis=0)
    left = np.concatenate(left_blocks).astype(np.int64)
    right = np.concatenate(right_blocks).astype(np.int64)
    order = np.lexsort(tuple(cands[:, wi] for wi in range(W)))
    return cands[order], left[order], right[order]


def join(prev: np.ndarray, k_prev: int, block: int = _DEF_BLOCK,
         method: str = "prefix") -> np.ndarray:
    """Classic Apriori join of size-``k_prev`` itemsets → size-``k_prev+1``
    candidates, in a ``mine.join`` span."""
    tracer = current_tracer()
    with tracer.span("mine.join", k=k_prev + 1) as span:
        out = join_pairs(prev, k_prev, block=block, method=method)[0]
        if tracer.enabled:
            span.set(n_in=len(prev), n_out=int(out.shape[0]))
    return out


@dataclasses.dataclass
class SpecJoin:
    """A speculative join of a level's *candidates* ``C`` (superset of its
    frequents ``L``), computed while the level's counting job is in flight.

    ``cands[i] = src[left[i]] | src[right[i]]``.  Because every
    ``(k+1)``-itemset arises from exactly one unordered pair and the canonical
    lexsort order is preserved under subsetting, filtering pairs with the keep
    mask over ``C`` reproduces ``join(L)`` exactly — rows, order and all.
    """
    cands: np.ndarray       # (M, W) joined candidates, canonically ordered
    left: np.ndarray        # (M,) parent row index into the source level
    right: np.ndarray       # (M,)
    n_src: int              # number of source-level candidates (len of keep)
    k: int = 0              # the joined level (source level + 1)

    def resolve(self, keep: np.ndarray) -> np.ndarray:
        """Exact ``join(src[keep])`` via pair filtering (no re-join), in a
        ``mine.join`` span like :func:`join`'s."""
        assert keep.shape[0] == self.n_src, (keep.shape, self.n_src)
        tracer = current_tracer()
        with tracer.span("mine.join", k=self.k, spec=True) as span:
            out = self.cands[keep[self.left] & keep[self.right]]
            if tracer.enabled:
                span.set(n_in=int(keep.sum()), n_out=int(out.shape[0]))
        return out


def speculative_join(cands: np.ndarray, k: int,
                     block: int = _DEF_BLOCK) -> SpecJoin:
    """Join the un-filtered candidates of level ``k`` with parent bookkeeping."""
    out, left, right = join_pairs(cands, k, block=block, method="prefix")
    return SpecJoin(out, left, right, n_src=np.asarray(cands).shape[0],
                    k=k + 1)


def prune(cands: np.ndarray, prev: np.ndarray, k_prev: int) -> np.ndarray:
    """Apriori-property prune: keep candidates all of whose ``k_prev``-subsets
    ∈ prev, in a ``mine.prune`` span."""
    cands = np.asarray(cands, dtype=np.uint32)
    tracer = current_tracer()
    with tracer.span("mine.prune", k=k_prev + 1) as span:
        out = _prune(cands, prev, k_prev)
        if tracer.enabled:
            span.set(n_in=int(cands.shape[0]), n_out=int(out.shape[0]))
    return out


def _prune(cands: np.ndarray, prev: np.ndarray, k_prev: int) -> np.ndarray:
    if cands.shape[0] == 0:
        return cands
    index = MaskIndex(prev)
    bitmat = _bit_matrix(cands)
    rows, cols = np.nonzero(bitmat)
    subsets = cands[rows].copy()
    subsets[np.arange(rows.size), cols // WORD_BITS] ^= (
        np.uint32(1) << (cols % WORD_BITS).astype(np.uint32))
    present = index.contains(subsets)
    missing_per_row = np.bincount(rows, weights=(~present).astype(np.int64),
                                  minlength=cands.shape[0])
    return cands[missing_per_row == 0]


def apriori_gen(prev: np.ndarray, k_prev: int, block: int = _DEF_BLOCK,
                method: str = "prefix") -> np.ndarray:
    """join + prune (the paper's ``apriori-gen()``)."""
    return prune(join(prev, k_prev, block=block, method=method), prev, k_prev)


def non_apriori_gen(prev: np.ndarray, k_prev: int, block: int = _DEF_BLOCK,
                    method: str = "prefix") -> np.ndarray:
    """join only — skipped-pruning (the paper's ``non-apriori-gen()``, §4.2)."""
    return join(prev, k_prev, block=block, method=method)
