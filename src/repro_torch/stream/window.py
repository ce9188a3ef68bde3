"""Transaction window: a bit-packed ring buffer of the live transaction set
under streaming load (DESIGN.md §8) — the port of the JAX package's
``stream/window.py``.

Transactions are packed to ``(W,)`` uint32 bitmasks on entry (``core/bitset``,
§2) and stored in one host ring, the exact source of truth for evicted-slab
extraction and for the full re-mine fallback (``scatter_db`` wants host
rows).  Only the O(delta) slabs a mutation returns go to the device, for
delta counting; the window itself never does.

Capacity is pow2-bucketed.  ``mode="sliding"`` evicts oldest-first when an
append overflows; ``mode="landmark"`` never evicts and grows the ring to the
next power of two instead.  Every mutation returns the exact added/evicted
bitmask slabs — precisely what ``kernels/delta_count.py`` needs to keep
tracked support counts current in O(delta).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.bitset import n_words, pack_itemsets
from repro_torch.kernels.autotune import _bucket

MIN_CAPACITY = 64


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
    """

    MODES = ("sliding", "landmark")

    def __init__(self, n_items: int, capacity: int = 1024,
                 mode: str = "sliding"):
        if mode not in self.MODES:
            raise ValueError(f"unknown mode {mode!r}; options: {self.MODES}")
        self.n_items = n_items
        self.mode = mode
        self.W = n_words(n_items)
        self.capacity = max(MIN_CAPACITY, _bucket(capacity))
        self._start = 0
        self._size = 0
        self._host = np.zeros((self.capacity, self.W), np.uint32)

    def __len__(self) -> int:
        return self._size

    @property
    def size(self) -> int:
        return self._size

    # -- internals -------------------------------------------------------------

    def _slots(self, logical: np.ndarray) -> np.ndarray:
        return (self._start + logical) % self.capacity

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

    def _pop(self, n: int) -> np.ndarray:
        """Evict the ``n`` oldest rows; returns their masks (host copy)."""
        n = min(n, self._size)
        if n == 0:
            return np.zeros((0, self.W), np.uint32)
        slots = self._slots(np.arange(n))
        out = self._host[slots].copy()
        self._host[slots] = 0
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
            evicted = self._pop(max(0, self._size + B - self.capacity))
        slots = self._slots(np.arange(self._size, self._size + B))
        self._host[slots] = masks
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
