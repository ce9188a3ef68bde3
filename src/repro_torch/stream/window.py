"""Device-resident transaction window: a bit-packed ring buffer of the live
transaction set under streaming load (DESIGN.md §8) — the port of the JAX
package's ``stream/window.py``.

Transactions are packed to ``(W,)`` uint32 bitmasks on entry (``core/bitset``,
§2) and stored twice in the same ring layout:

* a host mirror — the exact source of truth for evicted-slab extraction and
  for the full re-mine fallback (``scatter_db`` wants host rows);
* a device ring — int32 views of the words, updated in place per
  micro-batch with one ``index_copy_`` (pow2-bucketed row padding aimed at a
  dummy slot, so the streaming loop touches a handful of shapes and ships
  only the O(delta) slab to the device, never the window).

Capacity is pow2-bucketed.  ``mode="sliding"`` evicts oldest-first when an
append overflows; ``mode="landmark"`` never evicts and grows the ring to the
next power of two instead.  Every mutation returns the exact added/evicted
bitmask slabs — precisely what ``kernels/delta_count.py`` needs to keep
tracked support counts current in O(delta).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.bitset import n_words, pack_itemsets, to_device_words
from repro_torch.core.mapreduce import resolve_device
from repro_torch.kernels.autotune import _bucket

MIN_CAPACITY = 64
MIN_WRITE_BUCKET = 32      # pow2 row padding of the per-update device scatter


@dataclasses.dataclass
class WindowDelta:
    """Exact bitmask slabs of one window mutation."""
    added: np.ndarray       # (A, W) uint32 transactions that entered
    evicted: np.ndarray     # (E, W) uint32 transactions that left

    @property
    def n_added(self) -> int:
        return self.added.shape[0]

    @property
    def n_evicted(self) -> int:
        return self.evicted.shape[0]


class TransactionWindow:
    """Pow2-capacity ring buffer of bit-packed transactions.

    Args:
      n_items: item catalog size (fixes the mask width W).
      capacity: requested capacity; bucketed up to a power of two
        (≥ ``MIN_CAPACITY``).  In ``landmark`` mode this is only the initial
        allocation — the ring grows by doubling.
      mode: "sliding" (append evicts oldest-first on overflow) or
        "landmark" (append grows the ring, nothing auto-evicts).
      device: where the ring lives — "cuda" (default; raises without a
        card) or "cpu".
    """

    MODES = ("sliding", "landmark")

    def __init__(self, n_items: int, capacity: int = 1024,
                 mode: str = "sliding", device="cuda"):
        if mode not in self.MODES:
            raise ValueError(f"unknown mode {mode!r}; options: {self.MODES}")
        self.device = resolve_device(device)
        self.n_items = n_items
        self.mode = mode
        self.W = n_words(n_items)
        self.capacity = max(MIN_CAPACITY, _bucket(capacity))
        self._start = 0
        self._size = 0
        self._host = np.zeros((self.capacity, self.W), np.uint32)
        # +1 dummy slot: padded scatter rows land there, not on live data
        self._dev = torch.zeros((self.capacity + 1, self.W),
                                dtype=torch.int32, device=self.device)

    def __len__(self) -> int:
        return self._size

    @property
    def size(self) -> int:
        return self._size

    # -- internals -------------------------------------------------------------

    def _slots(self, logical: np.ndarray) -> np.ndarray:
        return (self._start + logical) % self.capacity

    def _dev_write(self, rows: np.ndarray, slots: np.ndarray) -> None:
        """One in-place ``index_copy_``: rows padded to a pow2 bucket, pad
        rows aimed at the dummy slot — the extra last row — so padding never
        clobbers live data."""
        n = rows.shape[0]
        if n == 0:
            return
        b = max(MIN_WRITE_BUCKET, _bucket(n))
        pad = b - n
        if pad:
            rows = np.concatenate(
                [rows, np.zeros((pad, self.W), np.uint32)], axis=0)
            slots = np.concatenate(
                [slots, np.full(pad, self.capacity, np.int64)])
        self._dev.index_copy_(
            0, torch.from_numpy(slots.astype(np.int64)).to(self.device),
            to_device_words(rows, self.device))

    def _grow(self, need: int) -> None:
        cap = self.capacity
        while cap < need:
            cap *= 2
        if cap == self.capacity:
            return
        live = self.contents()
        self.capacity = cap
        self._host = np.zeros((cap, self.W), np.uint32)
        self._host[:live.shape[0]] = live
        self._start = 0
        self._dev = to_device_words(
            np.concatenate([self._host, np.zeros((1, self.W), np.uint32)]),
            self.device)

    def _pop(self, n: int, zero_device: bool = True) -> np.ndarray:
        """Evict the ``n`` oldest rows; returns their masks (host copy).

        ``zero_device=False`` skips the device zero-scatter — an overflowing
        append always rewrites every freed slot in its own scatter (the last
        ``n`` batch rows land exactly there), so the hot path pays one device
        dispatch per update, not two."""
        n = min(n, self._size)
        if n == 0:
            return np.zeros((0, self.W), np.uint32)
        slots = self._slots(np.arange(n))
        out = self._host[slots].copy()
        self._host[slots] = 0
        if zero_device:
            self._dev_write(np.zeros((n, self.W), np.uint32), slots)
        self._start = (self._start + n) % self.capacity
        self._size -= n
        return out

    # -- mutations -------------------------------------------------------------

    def append(self, transactions=None, *, masks=None) -> WindowDelta:
        """Append a micro-batch (item-id lists or pre-packed masks).

        Sliding mode evicts oldest-first to make room; landmark mode grows the
        ring.  Returns the exact net :class:`WindowDelta` — a batch larger
        than the sliding capacity keeps only its newest ``capacity`` rows, and
        the overflow never enters the window (so delta counting stays exact).
        """
        if masks is None:
            masks = pack_itemsets([list(t) for t in transactions],
                                  self.n_items)
        masks = np.asarray(masks, np.uint32).reshape(-1, self.W)
        B = masks.shape[0]
        if B == 0:
            return WindowDelta(masks, np.zeros((0, self.W), np.uint32))
        if self.mode == "landmark":
            self._grow(self._size + B)
            evicted = np.zeros((0, self.W), np.uint32)
        else:
            if B > self.capacity:        # only the newest rows can survive
                masks = masks[B - self.capacity:]
                B = masks.shape[0]
            # freed slots are a subset of this append's own write range
            # (size' + B fills the window up to exactly the old start), so
            # the device zero-scatter would be overwritten immediately
            evicted = self._pop(max(0, self._size + B - self.capacity),
                                zero_device=False)
        slots = self._slots(np.arange(self._size, self._size + B))
        self._host[slots] = masks
        self._dev_write(masks, slots)
        self._size += B
        return WindowDelta(masks.copy(), evicted)

    def evict(self, n: int) -> WindowDelta:
        """Explicitly evict the ``n`` oldest transactions (either mode)."""
        evicted = self._pop(n)
        return WindowDelta(np.zeros((0, self.W), np.uint32), evicted)

    # -- views -----------------------------------------------------------------

    def contents(self) -> np.ndarray:
        """(size, W) uint32 live transactions, oldest first (host copy)."""
        return self._host[self._slots(np.arange(self._size))].copy()

    def device_masks(self) -> torch.Tensor:
        """The (capacity, W) int32 device ring (vacant slots are zero rows —
        they never inflate a non-empty candidate's count, §2 padding
        note)."""
        return self._dev[:self.capacity]
