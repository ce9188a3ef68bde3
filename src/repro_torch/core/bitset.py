"""Bit-packed itemset algebra.

Transactions and candidate itemsets are represented as bitmasks over the item
catalog, packed into ``W = ceil(n_items / 32)`` uint32 words.  This replaces the
paper's prefix-tree (trie): on TPU there is no efficient pointer chasing, and the
trie's role — cheap subset testing of a transaction against many candidates — is
played by a dense, word-parallel ``(c & t) == c`` test that maps onto the VPU.

All host-side helpers are numpy (numpy >= 2.0 provides ``np.bitwise_count``)
and are copies of the JAX package's.  Device-side equivalents live next to
them with a ``t``-prefix and work on torch tensors.

On the device, words are held as ``int32`` tensors that view the same bits as
the host's ``uint32`` arrays (:func:`to_device_words` / :func:`to_host_words`):
torch has no right shift for ``uint32`` on the CPU, and no popcount op at all,
so the ``t``-helpers shift ``int32`` words and mask with ``& 1`` after every
shift (an arithmetic shift copies the sign bit, the mask drops it), and count
bits with SWAR arithmetic on ``int64``.
"""

from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32


def n_words(n_items: int) -> int:
    """Number of uint32 words needed for an ``n_items``-wide bitmask."""
    return (n_items + WORD_BITS - 1) // WORD_BITS


def pack_itemsets(itemsets, n_items: int) -> np.ndarray:
    """Pack an iterable of item-index iterables into an ``(N, W)`` uint32 array."""
    W = n_words(n_items)
    out = np.zeros((len(itemsets), W), dtype=np.uint32)
    for row, items in enumerate(itemsets):
        for it in items:
            if not 0 <= it < n_items:
                raise ValueError(f"item {it} out of range [0, {n_items})")
            out[row, it // WORD_BITS] |= np.uint32(1 << (it % WORD_BITS))
    return out


def unpack_itemsets(masks: np.ndarray) -> list[tuple[int, ...]]:
    """Inverse of :func:`pack_itemsets` — sorted item tuples per row."""
    masks = np.asarray(masks, dtype=np.uint32)
    out = []
    for row in masks:
        items = []
        for wi, word in enumerate(row):
            word = int(word)
            while word:
                low = word & -word
                items.append(wi * WORD_BITS + low.bit_length() - 1)
                word ^= low
        out.append(tuple(items))
    return out


def popcount_rows(masks: np.ndarray) -> np.ndarray:
    """Per-row popcount of an ``(N, W)`` uint32 array → ``(N,)`` int32."""
    return np.bitwise_count(np.asarray(masks, dtype=np.uint32)).sum(axis=1).astype(np.int32)


def singleton_masks(n_items: int) -> np.ndarray:
    """``(n_items, W)`` masks with exactly one bit set each (the 1-itemsets)."""
    W = n_words(n_items)
    out = np.zeros((n_items, W), dtype=np.uint32)
    idx = np.arange(n_items)
    out[idx, idx // WORD_BITS] = np.uint32(1) << (idx % WORD_BITS).astype(np.uint32)
    return out


def floor_log2(x: np.ndarray) -> np.ndarray:
    """floor(log2(x)) for positive ints via the float64 exponent field.

    Exact for x < 2^53 (uint32 qualifies); ~3× faster than np.log2 because it
    is a cast + shift + mask instead of a transcendental (§Perf iteration M-A).
    Zeros map to -1023-ish garbage — callers must mask.
    """
    f = x.astype(np.float64)
    return ((f.view(np.uint64) >> np.uint64(52)).astype(np.int64) & 0x7FF) - 1023


def highest_bit_index(masks: np.ndarray) -> np.ndarray:
    """Index of the highest set bit per ``(..., W)`` mask; -1 for empty masks."""
    masks = np.asarray(masks, dtype=np.uint32)
    *lead, W = masks.shape
    hi = np.full(lead, -1, dtype=np.int64)
    for wi in range(W):
        word = masks[..., wi].astype(np.int64)
        nz = word != 0
        if not nz.any():
            continue
        bl = floor_log2(np.where(nz, word, 1))
        hi = np.where(nz, wi * WORD_BITS + bl, hi)
    return hi


def lowest_bit_index(masks: np.ndarray) -> np.ndarray:
    """Index of the lowest set bit per ``(..., W)`` mask; ``W*32 + 1`` sentinel
    for empty masks."""
    masks = np.asarray(masks, dtype=np.uint32)
    *lead, W = masks.shape
    sentinel = W * WORD_BITS + 1
    lo = np.full(lead, sentinel, dtype=np.int64)
    for wi in range(W):
        word = masks[..., wi].astype(np.int64)
        nz = (word != 0) & (lo == sentinel)   # first word with a set bit wins
        if not nz.any():
            continue
        bl = floor_log2(np.where(nz, word & -word, 1))
        lo = np.where(nz, wi * WORD_BITS + bl, lo)
    return lo


# ---------------------------------------------------------------------------
# 64-bit order-independent-ish hashing of masks (host side, for membership).
# Rows are hashed word-by-word with distinct odd multipliers, so the hash is a
# function of the full (ordered) word vector — i.e. of the exact itemset.
# ---------------------------------------------------------------------------

_MULTS = np.array(
    [0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1, 0x9E3779B9,
     0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2D, 0x165667C5, 0xA2B2AE3B, 0x37D4EB2F],
    dtype=np.uint64,
)


def hash_rows(masks: np.ndarray) -> np.ndarray:
    """64-bit hash per row of an ``(N, W)`` uint32 array."""
    masks = np.asarray(masks, dtype=np.uint32)
    W = masks.shape[1]
    if W > len(_MULTS):  # extend multipliers deterministically
        reps = -(-W // len(_MULTS))
        mults = np.tile(_MULTS, reps)[:W]
    else:
        mults = _MULTS[:W]
    h = np.zeros(masks.shape[0], dtype=np.uint64)
    for wi in range(W):
        h ^= (masks[:, wi].astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)) * mults[wi]
        h ^= h >> np.uint64(29)
        h *= np.uint64(0xBF58476D1CE4E5B9)
    h ^= h >> np.uint64(32)
    return h


class MaskIndex:
    """Sorted-hash membership index over a set of masks.

    Hash collisions are resolved exactly: every probe verifies full word
    equality over the run of equal hashes.
    """

    def __init__(self, masks: np.ndarray):
        self.masks = np.asarray(masks, dtype=np.uint32)
        h = hash_rows(self.masks)
        self._order = np.argsort(h, kind="stable")
        self.sorted_hashes = h[self._order]
        self.sorted_masks = self.masks[self._order]

    def __len__(self) -> int:
        return self.masks.shape[0]

    def find(self, queries: np.ndarray) -> np.ndarray:
        """Vectorized exact lookup → (Q,) int64 row index into the original
        ``masks`` array, or -1 where a query mask is absent."""
        queries = np.asarray(queries, dtype=np.uint32)
        out = np.full(queries.shape[0], -1, dtype=np.int64)
        if len(self) == 0 or queries.shape[0] == 0:
            return out
        qh = hash_rows(queries)
        left = np.searchsorted(self.sorted_hashes, qh, side="left")
        pending = np.arange(queries.shape[0])
        offset = 0
        # Walk equal-hash runs; in practice the first probe resolves ~all rows.
        while pending.size:
            pos = left[pending] + offset
            valid = pos < len(self.sorted_hashes)
            vpend = pending[valid]
            vpos = pos[valid]
            same_hash = self.sorted_hashes[vpos] == qh[vpend]
            vpend = vpend[same_hash]
            vpos = vpos[same_hash]
            if vpend.size == 0:
                break
            eq = (self.sorted_masks[vpos] == queries[vpend]).all(axis=1)
            out[vpend[eq]] = self._order[vpos[eq]]
            pending = vpend[~eq]
            offset += 1
        return out

    def contains(self, queries: np.ndarray) -> np.ndarray:
        """Vectorized exact membership test → (Q,) bool."""
        return self.find(queries) >= 0


def vertical_pack(db_masks: np.ndarray, n_items: int) -> np.ndarray:
    """Vertical (item-major) bitmap layout: row i = bitmap of transactions
    containing item i, packed along transactions.

    Returns ``(n_items + 1, Tw)`` uint32, ``Tw = ceil(N/32)``.  The extra last
    row is the **valid-transaction mask** (1 for every real transaction) — it
    doubles as the AND-identity used to pad variable-length candidates.

    support(candidate) = popcount(AND of its item rows) — §Perf iteration M-D
    (the vertical data layout of Jen et al., the paper's related work [15]).
    """
    db_masks = np.asarray(db_masks, dtype=np.uint32)
    n, W = db_masks.shape
    Tw = (n + WORD_BITS - 1) // WORD_BITS
    # expand to a (n_items+1, N) bit matrix (last row = valid mask), then
    # pack along transactions (little bit-order → uint32 view is bit j%32 of
    # word j//32, matching the horizontal convention)
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    bits = ((db_masks[:, :, None] >> shifts[None, None, :]) & np.uint32(1))
    bits = bits.reshape(n, W * WORD_BITS)[:, :n_items].astype(np.uint8)
    bits = np.concatenate([bits, np.ones((n, 1), np.uint8)], axis=1)  # valid
    bt = np.ascontiguousarray(bits.T)                 # (n_items+1, N)
    pad = Tw * WORD_BITS - n
    if pad:
        bt = np.concatenate([bt, np.zeros((bt.shape[0], pad), np.uint8)], axis=1)
    packed = np.packbits(bt, axis=1, bitorder="little")
    return np.ascontiguousarray(packed.view(np.uint32))


# ---------------------------------------------------------------------------
# Device-side (torch) equivalents on int32 views of the words.
# ---------------------------------------------------------------------------

def to_device_words(masks: np.ndarray, device) -> torch.Tensor:
    """Host ``(..., W)`` uint32 words → an int32 tensor of the same bits."""
    words = np.ascontiguousarray(masks, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(words).to(device)


def to_host_words(words: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`to_device_words`: int32 tensor → uint32 numpy."""
    return words.cpu().numpy().view(np.uint32)


def tpopcount(words: torch.Tensor) -> torch.Tensor:
    """Elementwise popcount of int32 words → int64 (SWAR on int64)."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def tpopcount_rows(masks: torch.Tensor) -> torch.Tensor:
    """Per-row popcount on device → (N,) int32."""
    return tpopcount(masks).sum(dim=-1).to(torch.int32)


def tunpack_bits(masks: torch.Tensor) -> torch.Tensor:
    """Bit-plane unpack: ``(..., W)`` int32 words → ``(..., W*32)`` int8.

    Column ``w*32 + b`` is bit ``b`` of word ``w`` — the little bit-order of
    the reference's ``junpack_bits``.  ``>>`` on int32 is arithmetic, so the
    ``& 1`` after the shift is what makes bit 31 come out as 0/1.
    """
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=masks.device)
    bits = (masks.to(torch.int32).unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*masks.shape[:-1],
                        masks.shape[-1] * WORD_BITS).to(torch.int8)


def _wrap_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) → int32 with the same low 32 bits."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def tpack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`tunpack_bits`: ``(..., B)`` int8/bool →
    ``(..., ceil(B/32))`` int32 words (B is zero-padded to the word multiple)."""
    B = bits.shape[-1]
    pad = (-B) % WORD_BITS
    if pad:
        bits = torch.cat([bits, bits.new_zeros((*bits.shape[:-1], pad))], dim=-1)
    words = bits.reshape(*bits.shape[:-1], -1, WORD_BITS).to(torch.int64)
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=bits.device)
    return _wrap_int32((words << shifts).sum(dim=-1))
