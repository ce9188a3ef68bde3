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

Candidates come out in *canonical order*: strictly increasing as multiword
integers, high word first.  Every level a mine joins is in that order, and
for such a level the canonical order of the join is that of ``(highest item,
lower parent)``: a candidate ``a | b`` holds exactly ``a``'s items below its
top item, ``b``'s highest.

Generation runs where the mine's runtime runs (DESIGN.md §2).  Given a
``device`` that is a card, ``join_pairs``, ``join``, ``prune``,
``apriori_gen``, ``non_apriori_gen`` and ``speculative_join`` upload the
level, run the CUDA kernels of :mod:`repro_torch.kernels.candidate_gen` on
generation's own stream, and bring the result home: numpy in, numpy out,
byte for byte the host code's.  With no device, or the CPU, they run the
host's vectorised numpy (the Hadoop analogue is the in-mapper trie
construction).  The heavy phase — support counting over the
transaction shards — is the device path in :mod:`repro_torch.core.counting`.

``speculative_join`` supports the async phase pipeline (DESIGN.md §4): while a
counting job is in flight, the *next* phase's join is computed over the current
level's un-filtered candidates with parent bookkeeping, so that once the keep
mask arrives the exact ``join(L)`` is recovered by pair filtering instead of a
fresh O(|L|²) pass.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.obs.trace import current_tracer

from .bitset import WORD_BITS, MaskIndex, highest_bit_index, to_device_words


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


def join_pairs(prev: np.ndarray, k_prev: int, device=None):
    """Classic Apriori join with parent bookkeeping.

    Returns ``(cands, left, right)`` where ``cands[i] = prev[left[i]] |
    prev[right[i]]``.  ``cands`` is canonically ordered (lexicographic by
    words, high word first).  Pairs are enumerated within shared-(k-1)-prefix
    groups — O(output) work, or on a card ``device`` the kernels' (item, row)
    grid; both produce byte-identical results.
    """
    prev = np.asarray(prev, dtype=np.uint32)
    n, W = prev.shape
    if n < 2:
        return (np.zeros((0, W), dtype=np.uint32),
                np.zeros(0, np.int64), np.zeros(0, np.int64))
    card = _card(device)
    if card is not None:
        return _join_on(prev, card)
    return _join_pairs_prefix(prev)


def join(prev: np.ndarray, k_prev: int, device=None) -> np.ndarray:
    """Classic Apriori join of size-``k_prev`` itemsets → size-``k_prev+1``
    candidates, in a ``mine.join`` span (``on_device``: on the card)."""
    prev = np.asarray(prev, dtype=np.uint32)
    card = _card(device)
    with _gen_span("mine.join", k_prev + 1, len(prev), card) as out:
        if card is None:
            out.append(join_pairs(prev, k_prev)[0])
        else:
            out.append(_join_on(prev, card, parents=False)[0])
    return out[0]


@contextlib.contextmanager
def _gen_span(name: str, k: int, n_in: int, card):
    """A ``mine.join`` or ``mine.prune`` span, ``on_device`` unless
    ``card`` is None (the host's numpy); the body appends its output rows to
    the list it is given, whose count is the span's ``n_out`` where tracing
    is on."""
    tracer = current_tracer()
    with tracer.span(name, k=k, on_device=card is not None) as span:
        out = []
        yield out
        if tracer.enabled:
            span.set(n_in=n_in, n_out=int(out[0].shape[0]))


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
    on_device: bool = False  # the join ran on the card

    def resolve(self, keep: np.ndarray) -> np.ndarray:
        """Exact ``join(src[keep])`` via pair filtering (no re-join), in a
        ``mine.join`` span like :func:`join`'s (``on_device``: where the
        join that it filters ran)."""
        assert keep.shape[0] == self.n_src, (keep.shape, self.n_src)
        tracer = current_tracer()
        with tracer.span("mine.join", k=self.k, spec=True,
                         on_device=self.on_device) as span:
            out = self.cands[keep[self.left] & keep[self.right]]
            if tracer.enabled:
                span.set(n_in=int(keep.sum()), n_out=int(out.shape[0]))
        return out


def speculative_join(cands: np.ndarray, k: int, device=None) -> SpecJoin:
    """Join the un-filtered candidates of level ``k`` with parent bookkeeping."""
    out, left, right = join_pairs(cands, k, device=device)
    return SpecJoin(out, left, right, n_src=np.asarray(cands).shape[0],
                    k=k + 1, on_device=_card(device) is not None)


def prune(cands: np.ndarray, prev: np.ndarray, k_prev: int,
          device=None) -> np.ndarray:
    """Apriori-property prune: keep candidates all of whose ``k_prev``-subsets
    ∈ prev, in a ``mine.prune`` span (``on_device``: on the card)."""
    cands = np.asarray(cands, dtype=np.uint32)
    card = _card(device)
    with _gen_span("mine.prune", k_prev + 1, cands.shape[0], card) as out:
        if card is None:
            out.append(_prune(cands, prev, k_prev))
        else:
            out.append(_prune_on(cands, np.asarray(prev, dtype=np.uint32),
                                 card))
    return out[0]


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


def apriori_gen(prev: np.ndarray, k_prev: int, device=None) -> np.ndarray:
    """join + prune (the paper's ``apriori-gen()``).  On a card ``device``
    the join's candidates stay on the card for the prune and only the
    pruned ones come home."""
    card = _card(device)
    prev = np.asarray(prev, dtype=np.uint32)
    if card is None or prev.shape[0] < 2:
        return prune(join(prev, k_prev), prev, k_prev, device=card)
    return _apriori_gen_on(prev, k_prev, card)


def non_apriori_gen(prev: np.ndarray, k_prev: int, device=None) -> np.ndarray:
    """join only — skipped-pruning (the paper's ``non-apriori-gen()``, §4.2)."""
    return join(prev, k_prev, device=device)


# -- on a device: the kernels of kernels/candidate_gen.py ---------------------

_GEN_STREAMS: dict = {}


def _card(device):
    """``device`` as a torch.device where it is a card, else None (the
    host's numpy)."""
    if device is None:
        return None
    device = torch.device(device)
    return device if device.type == "cuda" else None


def _on_stream(device):
    """Generation's own CUDA stream on ``device`` (nothing for the CPU): its
    waits, the count read and the copies home, never wait on a counting job
    in flight on the runtime's stream."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    if index not in _GEN_STREAMS:
        _GEN_STREAMS[index] = torch.cuda.Stream(device=index)
    return torch.cuda.stream(_GEN_STREAMS[index])


def _upload(rows: np.ndarray, device) -> torch.Tensor:
    """Host uint32 rows → int32 words on ``device``.  To a card: staged in a
    page-locked buffer and copied on the current stream without a wait."""
    if device.type != "cuda":
        return to_device_words(rows, device)
    staged = torch.empty(rows.shape, dtype=torch.int32, pin_memory=True)
    staged.numpy().view(np.uint32)[...] = rows
    return staged.to(device, non_blocking=True)


def _home(*tensors) -> list:
    """The tensors as numpy arrays on the host.  From a card: copied into
    page-locked buffers on the current stream, then one wait on it."""
    if tensors[0].device.type != "cuda":
        return [t.numpy() for t in tensors]
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [h.numpy() for h in host]


def _canonical(rows: np.ndarray) -> np.ndarray:
    """The permutation that puts ``rows`` in canonical order."""
    return np.lexsort(rows.T)          # the last key, word W-1, decides first


def _join_words_on(prev: np.ndarray, device, parents: bool):
    """The join of ``prev`` (n ≥ 2 rows) by :func:`kernels.candidate_gen.
    join_words` on ``device``, inside :func:`_on_stream`: ``(level, order,
    cands, left, right)``, the level's words on the device in canonical
    order and the join's tensors.  A level out of canonical order is sorted
    first (``order``: the sort, else None); one with a row twice is
    refused."""
    from repro_torch.kernels import candidate_gen
    try:
        level = _upload(prev, device)
        return (level, None) + candidate_gen.join_words(level, parents)
    except candidate_gen.UnsortedLevel:
        order = _canonical(prev)
        rows = prev[order]
        if (rows[1:] == rows[:-1]).all(axis=1).any():
            raise ValueError("the level holds a row twice: a join takes "
                             "distinct rows") from None
        level = _upload(rows, device)
        return (level, order) + candidate_gen.join_words(level, parents)


def _join_on(prev: np.ndarray, device, parents: bool = True):
    """:func:`join_pairs`' prefix join on ``device`` (the kernels on a card,
    their plain version on the CPU): ``(cands, left, right)`` home as
    uint32 and int64 arrays, ``left``/``right`` None without ``parents``;
    for a level out of canonical order, ``left``/``right`` are the lower and
    higher of the original rows, as the numpy join yields them."""
    n, W = prev.shape
    if n < 2:
        empty = np.zeros(0, np.int64) if parents else None
        return (np.zeros((0, W), dtype=np.uint32), empty,
                None if empty is None else empty.copy())
    with _on_stream(device):
        _, order, cands, left, right = _join_words_on(prev, device, parents)
        if not parents:
            return _home(cands)[0].view(np.uint32), None, None
        cands, left, right = _home(cands, left, right)
    if order is not None:
        a, b = order[left], order[right]
        left, right = np.minimum(a, b), np.maximum(a, b)
    return cands.view(np.uint32), left, right


def _apriori_gen_on(prev: np.ndarray, k_prev: int, device) -> np.ndarray:
    """:func:`apriori_gen` on ``device`` (n ≥ 2 rows), in its ``mine.join``
    and ``mine.prune`` spans: the join's candidates and the level stay on
    the device for the prune, and the pruned candidates come home."""
    from repro_torch.kernels import candidate_gen
    with _on_stream(device):
        with _gen_span("mine.join", k_prev + 1, prev.shape[0], device) as out:
            level, _, cands, _, _ = _join_words_on(prev, device,
                                                   parents=False)
            out.append(cands)
        with _gen_span("mine.prune", k_prev + 1, cands.shape[0],
                       device) as out:
            kept = candidate_gen.prune_words(cands, level)
            out.append(_home(kept)[0].view(np.uint32))
    return out[0]


def _prune_on(cands: np.ndarray, prev: np.ndarray, device) -> np.ndarray:
    """:func:`_prune` by :func:`kernels.candidate_gen.prune_words` on
    ``device`` (the plain version on the CPU); ``cands`` itself where every
    candidate is kept.  A ``prev`` out of order is sorted first."""
    from repro_torch.kernels import candidate_gen
    if cands.shape[0] == 0:
        return cands
    with _on_stream(device):
        words = _upload(cands, device)
        try:
            kept = candidate_gen.prune_words(words, _upload(prev, device))
        except candidate_gen.UnsortedLevel:
            kept = candidate_gen.prune_words(
                words, _upload(prev[_canonical(prev)], device))
        if kept.shape[0] == cands.shape[0]:
            return cands
        return _home(kept)[0].view(np.uint32)
