"""Streaming incremental-mining subsystem (DESIGN.md §8), on the port.

Turns the repo from "mine once" into "mine continuously": a device-resident
:class:`TransactionWindow` absorbs append/evict micro-batches, tracked
candidate tables are maintained with O(delta) signed counting
(``kernels/delta_count.py``), and a :class:`StreamMiner` republishes exact
frequent itemsets — and a fresh :class:`~repro_torch.core.rules.RuleSet` into its
live :class:`~repro_torch.serving.rules_engine.RuleServeEngine` — after every
update, falling back to policy-driven full re-mining when the itemset
structure drifts.
"""

from .window import TransactionWindow, WindowDelta
from .tables import TrackedTables, derive_frequent, levels_equal
from .miner import StreamMiner, StreamUpdate

__all__ = [
    "TransactionWindow", "WindowDelta",
    "TrackedTables", "derive_frequent", "levels_equal",
    "StreamMiner", "StreamUpdate",
]
