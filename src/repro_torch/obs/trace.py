"""Nested spans + Chrome-trace-event export (DESIGN.md §13).

One mine→stream→serve run becomes a single timeline that opens in
``ui.perfetto.dev``: spans wrap each mine level (gen/count/spec-join,
repartition, re-scatter), StreamMiner updates and re-mines, and each served
query (admission → queue wait → device dispatch), with cost-controller
decisions attached as instant events carrying predicted-vs-measured
residuals.

Design points:

* **Injectable clock** — ``Tracer(clock=FakeClock())`` gives deterministic
  span trees in tests (exact start/duration assertions, no sleeps);
  production uses :class:`~repro_torch.obs.clock.MonotonicClock`.
* **No-op fast path** — the module-level current tracer defaults to
  :data:`NULL_TRACER`, whose ``span()`` returns one shared ``_NullSpan``
  singleton; call sites pay one function call + an attribute check when
  tracing is off.
* **Virtual-time tracks** — :meth:`Tracer.add_span` records spans with
  caller-supplied start/end (the open-loop server's virtual arrival clock),
  on their own ``tid`` track; the exporter normalizes timestamps *per track*
  so wall-clock and virtual-time tracks both start at 0.
"""

from __future__ import annotations

import contextlib
import json
from typing import Any, Optional

from repro_torch.obs.clock import MonotonicClock

__all__ = [
    "Span", "Tracer", "NullTracer", "NULL_TRACER",
    "current_tracer", "set_tracer", "use_tracer",
]


class Span:
    """A named interval with attributes and attached instant events.

    Acts as its own context manager: ``t0`` is stamped at creation,
    ``t1`` on ``__exit__``/``close``.
    """

    __slots__ = ("name", "tid", "t0", "t1", "attrs", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, tid: str,
                 t0: float, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.tid = tid
        self.t0 = t0
        self.t1: Optional[float] = None
        self.attrs = attrs

    @property
    def duration(self) -> float:
        return (self.t1 if self.t1 is not None else self.t0) - self.t0

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def event(self, name: str, **attrs) -> None:
        """Attach an instant event at the current clock time, on this
        span's track."""
        self._tracer.event(name, tid=self.tid, **attrs)

    def close(self) -> "Span":
        if self.t1 is None:
            self._tracer._close(self)
        return self

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class Tracer:
    """Collects spans + instant events; exports Chrome trace-event JSON."""

    enabled = True

    def __init__(self, clock=None, pid: int = 0):
        self.clock = clock if clock is not None else MonotonicClock()
        self.pid = pid
        self.spans: list[Span] = []
        self.events: list[dict] = []
        self._stack: list[Span] = []

    # -- recording ---------------------------------------------------------
    def span(self, name: str, tid: str = "main", **attrs) -> Span:
        """Open a nested span on the live clock; close via ``with`` or
        ``.close()``."""
        s = Span(self, name, tid, self.clock.now(), attrs)
        self.spans.append(s)
        self._stack.append(s)
        return s

    def _close(self, s: Span) -> None:
        s.t1 = self.clock.now()
        if s in self._stack:            # tolerate out-of-order closes
            self._stack.remove(s)

    def add_span(self, name: str, t0: float, t1: float,
                 tid: str = "virtual", **attrs) -> Span:
        """Record a completed span with caller-supplied times (virtual-time
        tracks: open-loop query lifetimes, device busy intervals)."""
        s = Span(self, name, tid, float(t0), attrs)
        s.t1 = float(t1)
        self.spans.append(s)
        return s

    def event(self, name: str, tid: str = "main",
              args: Optional[dict] = None, **attrs) -> dict:
        """Record an instant event.  ``args`` may be a shared mutable dict —
        the cost controller uses this to backfill ``measured``/``residual``
        after the fact (export reads the final values)."""
        ev = {"name": name, "ts": self.clock.now(), "tid": tid,
              "args": args if args is not None else attrs}
        self.events.append(ev)
        return ev

    def current(self) -> Optional[Span]:
        return self._stack[-1] if self._stack else None

    # -- export ------------------------------------------------------------
    def to_chrome(self) -> dict:
        """Chrome trace-event JSON (object format), loadable in
        ``ui.perfetto.dev`` / ``chrome://tracing``.

        Timestamps are µs, normalized per ``tid`` track so wall-clock and
        virtual-time tracks each start at 0.  Open spans are closed at the
        current clock time.
        """
        now = self.clock.now()
        base: dict[str, float] = {}
        for s in self.spans:
            base[s.tid] = min(base.get(s.tid, s.t0), s.t0)
        for ev in self.events:
            base[ev["tid"]] = min(base.get(ev["tid"], ev["ts"]), ev["ts"])

        tids = {tid: i for i, tid in enumerate(sorted(base))}
        out: list[dict] = []
        for tid, idx in tids.items():
            out.append({"name": "thread_name", "ph": "M", "pid": self.pid,
                        "tid": idx, "args": {"name": tid}})
        for s in self.spans:
            t1 = s.t1 if s.t1 is not None else now
            out.append({
                "name": s.name, "ph": "X", "pid": self.pid,
                "tid": tids[s.tid],
                "ts": (s.t0 - base[s.tid]) * 1e6,
                "dur": (t1 - s.t0) * 1e6,
                "args": _jsonable(s.attrs)})
        for ev in self.events:
            out.append({
                "name": ev["name"], "ph": "i", "s": "t", "pid": self.pid,
                "tid": tids[ev["tid"]],
                "ts": (ev["ts"] - base[ev["tid"]]) * 1e6,
                "args": _jsonable(ev["args"])})
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export(self, path: str) -> dict:
        doc = self.to_chrome()
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        return doc


def _jsonable(d: dict) -> dict:
    """Coerce attr values to JSON-safe scalars (numpy ints/floats appear in
    span attributes; Perfetto rejects NaN-free JSON violations)."""
    out: dict[str, Any] = {}
    for k, v in d.items():
        if v is None or isinstance(v, (bool, str)):
            out[k] = v
        elif isinstance(v, (int, float)):
            out[k] = v
        elif isinstance(v, dict):
            out[k] = _jsonable(v)
        else:
            try:
                out[k] = float(v)
            except (TypeError, ValueError):
                out[k] = str(v)
    return out


class _NullSpan:
    """Shared do-nothing span — the disabled-tracing fast path."""

    __slots__ = ()
    name = tid = ""
    t0 = t1 = duration = 0.0
    attrs: dict = {}

    def set(self, **attrs):
        return self

    def event(self, name, **attrs):
        return None

    def close(self):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every call returns the shared null span."""

    enabled = False
    spans: list = []
    events: list = []

    def span(self, name, tid="main", **attrs):
        return _NULL_SPAN

    def add_span(self, name, t0, t1, tid="virtual", **attrs):
        return _NULL_SPAN

    def event(self, name, tid="main", args=None, **attrs):
        return None

    def current(self):
        return None


NULL_TRACER = NullTracer()

_current: Any = NULL_TRACER


def current_tracer():
    """The process-wide active tracer (``NULL_TRACER`` when tracing is
    off) — call sites grab this instead of threading a tracer argument
    through every layer."""
    return _current


def set_tracer(tracer):
    """Install ``tracer`` (or ``None`` → disable) as the active tracer."""
    global _current
    _current = tracer if tracer is not None else NULL_TRACER
    return _current


@contextlib.contextmanager
def use_tracer(tracer):
    """Scoped ``set_tracer`` — restores the previous tracer on exit."""
    global _current
    prev = _current
    _current = tracer if tracer is not None else NULL_TRACER
    try:
        yield _current
    finally:
        _current = prev
