"""Injectable clocks — the one timing contract every layer shares
(DESIGN.md §13).

The paper's elapsed-time-driven pass combining only works if per-phase timing
is trustworthy, and timing is only *testable* if it is injectable.  Two
clocks, one interface (``now() -> float`` seconds):

* :class:`MonotonicClock` — ``time.perf_counter`` (the production default:
  monotonic, unaffected by wall-clock jumps);
* :class:`FakeClock` — manually-advanced virtual time, so the tracer and
  ``costmodel.measure.time_once`` accept the *same* clock object in
  deterministic tests — no sleeps anywhere.
"""

from __future__ import annotations

import time


class MonotonicClock:
    """``time.perf_counter`` behind the injectable-clock interface."""

    __slots__ = ()

    def now(self) -> float:
        return time.perf_counter()


class FakeClock:
    """Manually-advanced virtual clock (no sleeps, no wall time)."""

    __slots__ = ("t",)

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t
