"""Candidate generation on the card: the Apriori join of a level and the
Apriori prune, as CUDA kernels (``csrc/candidate_gen.cu``), with their plain
PyTorch versions.

Words are int32 tensors holding the bits of the host's uint32 words
(:func:`~repro_torch.core.bitset.to_device_words`); both forms compare them
unsigned, as multiword integers with the high word first.  A level in
*canonical order* is strictly increasing so compared, which is the order in
which every level of a mine reaches the join.  For such a level ``L``:

* :func:`join_words` — every ``a | b`` for rows ``a = P ∪ {h_a}`` and
  ``b = P ∪ {h_b}`` of ``L`` with ``h_a < h_b`` their highest items, with
  ``left`` and ``right`` the rows of ``a`` and ``b``: byte for byte
  ``core/candidates.py::_join_pairs_prefix``.  Below its top item a
  candidate holds exactly ``a``'s items, so the canonical order of the
  candidates is that of ``(top item, left)``: for each item ``h`` and row
  ``i``, the candidate exists iff ``h`` lies above row ``i``'s highest item
  ``h_i`` and ``(L_i − {h_i}) ∪ {h}`` is a row of ``L`` — a binary search
  of ``L`` for each ``(h, i)``, a scan of the matches in ``(h, i)``
  row-major order, and a write at each match's rank.  No sort.
* :func:`prune_words` — the candidates whose every subset that drops one
  item is a row of ``L`` (sorted, equal rows allowed), in their order: a
  binary search a subset, then an order-keeping compaction.  Byte for byte
  ``core/candidates.py::_prune``.

Each wrapper runs its plain version for CPU tensors and launches its kernels
for CUDA tensors; it never falls back from one to the other.  A level out of
order raises :class:`UnsortedLevel` in both forms (the kernels find it in
their count pass, at no extra read).  The kernels replace no TPU kernel:
both packages generated candidates in host numpy.  Each wrapper calls its
C entry point (``candidate_join``, ``candidate_prune``) twice, and
``LAUNCHES`` counts both: the count pass with its scan, then, after the
read of the output count, the write pass, skipped where it would write
nothing new.
"""

from __future__ import annotations

import torch

from repro_torch.core.bitset import WORD_BITS

from . import _build
from .support_count import check_words

SCAN_BLOCKS = 1024                      # kScanBlocks in csrc/candidate_gen.cu
SCRATCH_INTS = 2 + 2 * SCAN_BLOCKS      # count, faults, block offsets, faults
MAX_FLAGS = 2**31 - 1                   # the join's (item, row) grid, int32


class UnsortedLevel(ValueError):
    """The level is out of canonical order: not strictly increasing (join),
    or decreasing somewhere (prune)."""


def _unsigned(words: torch.Tensor) -> torch.Tensor:
    """int32 words → int64 with the same 32 bits, unsigned."""
    return words.to(torch.int64) & 0xFFFFFFFF


def _compare_rows(a: torch.Tensor, b: torch.Tensor):
    """``(a < b, a == b)`` for ``(..., W)`` unsigned int64 rows, high word
    first."""
    less = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    equal = torch.ones_like(less)
    for w in range(a.shape[-1] - 1, -1, -1):
        less |= equal & (a[..., w] < b[..., w])
        equal &= a[..., w] == b[..., w]
    return less, equal


def _check_order(level: torch.Tensor, strict: bool) -> None:
    less, equal = _compare_rows(level[:-1], level[1:])
    if not bool((less if strict else less | equal).all()):
        raise UnsortedLevel("the level is not in canonical order (strictly "
                            "increasing words, high word first)" if strict
                            else "the level is not sorted")


def _find_rows(level: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Binary search of a sorted ``(n, W)`` level for each ``(Q, W)`` query
    (both unsigned int64): the first equal row, or -1."""
    n = level.shape[0]
    lo = torch.zeros(queries.shape[0], dtype=torch.int64,
                     device=queries.device)
    if n == 0:
        return lo - 1
    hi = torch.full_like(lo, n)
    for _ in range(n.bit_length()):
        mid = (lo + hi) // 2
        below, _ = _compare_rows(level[mid.clamp(max=n - 1)], queries)
        active = lo < hi
        lo = torch.where(active & below, mid + 1, lo)
        hi = torch.where(active & ~below, mid, hi)
    _, equal = _compare_rows(level[lo.clamp(max=n - 1)], queries)
    return torch.where((lo < n) & equal, lo, -1)


def _item_masks(items: torch.Tensor, W: int) -> torch.Tensor:
    """``(P,)`` item indices (-1: none) → ``(P, W)`` unsigned one-bit
    rows."""
    word = torch.arange(W, device=items.device)
    bit = torch.ones_like(items) << (items.clamp(min=0) % WORD_BITS)
    hit = ((word[None, :] == (items // WORD_BITS)[:, None])
           & (items >= 0)[:, None])
    return torch.where(hit, bit[:, None], 0)


def _top_items(rows: torch.Tensor) -> torch.Tensor:
    """Highest item of each unsigned ``(n, W)`` row, -1 for the empty row."""
    top = torch.full(rows.shape[:1], -1, dtype=torch.int64,
                     device=rows.device)
    for w in range(rows.shape[1]):
        word = rows[:, w]
        # frexp's exponent e has 2^(e-1) <= word < 2^e, exactly
        _, e = torch.frexp(word.to(torch.float64))
        top = torch.where(word != 0, w * WORD_BITS + e.to(torch.int64) - 1,
                          top)
    return top


def _to_words(rows: torch.Tensor) -> torch.Tensor:
    """Unsigned int64 rows → their int32 words."""
    return torch.where(rows >= 2**31, rows - 2**32, rows).to(torch.int32)


def _empty_join(W: int, device, parents: bool):
    empty = torch.zeros(0, dtype=torch.int64, device=device)
    return (torch.zeros((0, W), dtype=torch.int32, device=device),
            empty if parents else None, empty.clone() if parents else None)


# -- join ----------------------------------------------------------------------

def join_words_plain(level: torch.Tensor, parents: bool = True):
    """Plain version of :func:`join_words`: the ``(h, i)`` grid's binary
    searches at once, its matches compacted in row-major order."""
    n, W = level.shape
    if n < 2:
        return _empty_join(W, level.device, parents)
    rows = _unsigned(level)
    _check_order(rows, strict=True)
    top = _top_items(rows)
    items = torch.arange(W * WORD_BITS, device=level.device)
    h, i = torch.nonzero(items[:, None] > top[None, :], as_tuple=True)
    queries = (rows[i] ^ _item_masks(top[i], W)) | _item_masks(h, W)
    right = _find_rows(rows, queries)
    match = right >= 0
    h, i, right = h[match], i[match], right[match]
    cands = _to_words(rows[i] | _item_masks(h, W))
    return (cands, i if parents else None, right if parents else None)


def join_words(level: torch.Tensor, parents: bool = True):
    """The join of a level in canonical order: ``(cands (M, W) int32, left
    (M,) int64, right (M,) int64)``, canonically ordered, ``cands[m] =
    level[left[m]] | level[right[m]]``; ``left`` and ``right`` are None with
    ``parents=False`` (the kernel then writes only the candidates).  Raises
    :class:`UnsortedLevel` for a level out of canonical order."""
    if level.device.type == "cpu":
        return join_words_plain(level, parents)
    check_words("level", level, level.device)
    n, W = level.shape
    if n < 2:
        return _empty_join(W, level.device, parents)
    if WORD_BITS * W * n > MAX_FLAGS:
        raise ValueError(f"a join of {n} rows of {W} words has more than "
                         f"{MAX_FLAGS} (item, row) pairs")
    scratch = torch.empty(SCRATCH_INTS, dtype=torch.int32,
                          device=level.device)
    _build.launch("candidate_join", level.data_ptr(), n, W,
                  scratch.data_ptr(), None, None, None)
    total, faults = scratch[:2].tolist()        # the one read of a call
    if faults:
        raise UnsortedLevel("the level is not in canonical order (strictly "
                            "increasing words, high word first)")
    cands = torch.empty((total, W), dtype=torch.int32, device=level.device)
    left = right = None
    if parents:
        left = torch.empty(total, dtype=torch.int64, device=level.device)
        right = torch.empty(total, dtype=torch.int64, device=level.device)
    if total:
        _build.launch("candidate_join", level.data_ptr(), n, W,
                      scratch.data_ptr(), cands.data_ptr(),
                      left.data_ptr() if parents else None,
                      right.data_ptr() if parents else None)
    return cands, left, right


# -- prune ---------------------------------------------------------------------

def prune_words_plain(cands: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`prune_words`: a binary search for every
    subset of every candidate, then the kept rows in their order (the input
    tensor itself where every candidate is kept)."""
    m, W = cands.shape
    if m == 0:
        return cands
    rows = _unsigned(level)
    _check_order(rows, strict=False)
    c = _unsigned(cands)
    bit = (c[:, :, None] >> torch.arange(WORD_BITS, device=cands.device)) & 1
    j, item = torch.nonzero(bit.reshape(m, W * WORD_BITS), as_tuple=True)
    present = _find_rows(rows, c[j] ^ _item_masks(item, W)) >= 0
    missing = torch.zeros(m, dtype=torch.int64, device=cands.device)
    missing.index_add_(0, j, (~present).to(torch.int64))
    keep = missing == 0
    return cands if bool(keep.all()) else cands[keep]


def prune_words(cands: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
    """The ``(M, W)`` candidates whose every subset that drops one item is a
    row of ``level`` (sorted; equal rows allowed), in their order; the input
    tensor itself where every candidate is kept.  Raises
    :class:`UnsortedLevel` for a level that decreases somewhere."""
    if cands.device.type == "cpu" and level.device.type == "cpu":
        return prune_words_plain(cands, level)
    check_words("cands", cands, cands.device)
    check_words("level", level, cands.device)
    m, W = cands.shape
    if level.shape[1] != W:
        raise ValueError(f"word counts differ: cands {W}, level "
                         f"{level.shape[1]}")
    if m == 0:
        return cands
    n = level.shape[0]
    scratch = torch.empty(SCRATCH_INTS, dtype=torch.int32,
                          device=cands.device)
    _build.launch("candidate_prune", cands.data_ptr(), m, level.data_ptr(),
                  n, W, scratch.data_ptr(), None)
    total, faults = scratch[:2].tolist()        # the one read of a call
    if faults:
        raise UnsortedLevel("the level is not sorted")
    if total == m:
        return cands
    out = torch.empty((total, W), dtype=torch.int32, device=cands.device)
    if total:
        _build.launch("candidate_prune", cands.data_ptr(), m,
                      level.data_ptr(), n, W, scratch.data_ptr(),
                      out.data_ptr())
    return out
