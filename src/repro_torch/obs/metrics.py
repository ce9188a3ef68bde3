"""Process-wide metrics registry with a versioned JSON snapshot schema
(DESIGN.md §13).

Counters, gauges, and fixed-bucket latency histograms, keyed by name +
sorted labels (``serving.latency_ms{tenant=t0}``).  One registry is the
source of truth that ``RuntimeStats`` deltas, serving admission telemetry,
and cost-controller decision counts all feed; ``--metrics-out`` dumps
:meth:`Registry.snapshot` in the same format as the JAX package, and
``python -m repro_torch.obs.validate`` checks the snapshots.

Schema stability contract: :data:`SCHEMA_VERSION` names the exact field
layout produced by :meth:`Registry.snapshot`.  Changing any field requires
bumping the version — ``tests/test_obs.py`` pins the v1 layout as a golden
test, and :func:`validate_snapshot` rejects unknown versions.
"""

from __future__ import annotations

import bisect
from typing import Optional

__all__ = [
    "SCHEMA_VERSION", "DEFAULT_BUCKETS_MS",
    "Counter", "Gauge", "Histogram", "Registry",
    "get_registry", "set_registry", "validate_snapshot",
]

SCHEMA_VERSION = 1
KNOWN_VERSIONS = (1,)

# Log-spaced latency buckets in ms: 50 µs device dispatches up to multi-second
# mine phases land in distinct buckets; the final +inf bucket is implicit.
DEFAULT_BUCKETS_MS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
                      50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 10000.0)

HISTOGRAM_FIELDS = ("buckets", "counts", "count", "sum", "p50", "p99")
TOP_LEVEL_FIELDS = ("schema_version", "counters", "gauges", "histograms")


class Counter:
    """A cumulative value.  ``inc`` accepts negative deltas for net counts
    (e.g. an admitted query later displaced by fair shedding)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """A point-in-time value (last write wins)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram: per-bucket counts plus count/sum, with
    bucket-edge percentile estimates (p50/p99 accurate to bucket width)."""

    __slots__ = ("buckets", "counts", "count", "sum")

    def __init__(self, buckets=DEFAULT_BUCKETS_MS):
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)   # last = overflow
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.count += 1
        self.sum += v

    def percentile(self, q: float) -> float:
        """Upper edge of the bucket containing quantile ``q`` in [0, 100]
        (overflow bucket reports the observed mean of its tail bound)."""
        if self.count == 0:
            return 0.0
        rank = q / 100.0 * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank and c:
                if i < len(self.buckets):
                    return self.buckets[i]
                return self.sum / self.count  # overflow: fall back to mean
        return self.buckets[-1]


class Registry:
    """Name+label-keyed store of counters/gauges/histograms.

    The process-wide instance (:func:`get_registry`) backs CLI runs; tests
    and the per-server default in ``OpenLoopServer`` use private instances
    so concurrent servers cannot contaminate each other's fair-shedding
    accounting.
    """

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    @staticmethod
    def _key(name: str, labels: dict) -> str:
        if not labels:
            return name
        inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
        return f"{name}{{{inner}}}"

    def counter(self, name: str, **labels) -> Counter:
        key = self._key(name, labels)
        c = self._counters.get(key)
        if c is None:
            c = self._counters[key] = Counter()
        return c

    def gauge(self, name: str, **labels) -> Gauge:
        key = self._key(name, labels)
        g = self._gauges.get(key)
        if g is None:
            g = self._gauges[key] = Gauge()
        return g

    def histogram(self, name: str, buckets=None, **labels) -> Histogram:
        key = self._key(name, labels)
        h = self._histograms.get(key)
        if h is None:
            h = self._histograms[key] = Histogram(
                buckets if buckets is not None else DEFAULT_BUCKETS_MS)
        return h

    def value(self, name: str, **labels) -> float:
        """Read a counter/gauge value without creating it (0.0 if absent)."""
        key = self._key(name, labels)
        m = self._counters.get(key) or self._gauges.get(key)
        return m.value if m is not None else 0.0

    def snapshot(self) -> dict:
        """The versioned JSON document behind ``--metrics-out``.  Field
        layout is frozen per :data:`SCHEMA_VERSION` — see module docstring."""
        return {
            "schema_version": SCHEMA_VERSION,
            "counters": {k: c.value for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value for k, g in sorted(self._gauges.items())},
            "histograms": {
                k: {"buckets": list(h.buckets), "counts": list(h.counts),
                    "count": h.count, "sum": h.sum,
                    "p50": h.percentile(50), "p99": h.percentile(99)}
                for k, h in sorted(self._histograms.items())},
        }


def validate_snapshot(doc) -> list:
    """Validate a snapshot document against the versioned schema; returns a
    list of error strings (empty == valid)."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return [f"snapshot must be a JSON object, got {type(doc).__name__}"]
    for key in TOP_LEVEL_FIELDS:
        if key not in doc:
            errs.append(f"missing top-level field '{key}'")
    extra = set(doc) - set(TOP_LEVEL_FIELDS)
    if extra:
        errs.append(f"unknown top-level fields {sorted(extra)} — "
                    f"bump SCHEMA_VERSION to change the schema")
    if errs:
        return errs
    if doc["schema_version"] not in KNOWN_VERSIONS:
        errs.append(f"unknown schema_version {doc['schema_version']!r} "
                    f"(known: {list(KNOWN_VERSIONS)})")
    for section in ("counters", "gauges"):
        if not isinstance(doc[section], dict):
            errs.append(f"'{section}' must be an object")
            continue
        for k, v in doc[section].items():
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                errs.append(f"{section}[{k!r}] must be numeric, got {v!r}")
    if not isinstance(doc["histograms"], dict):
        errs.append("'histograms' must be an object")
        return errs
    for k, h in doc["histograms"].items():
        if not isinstance(h, dict):
            errs.append(f"histograms[{k!r}] must be an object")
            continue
        if set(h) != set(HISTOGRAM_FIELDS):
            errs.append(
                f"histograms[{k!r}] fields {sorted(h)} != schema v"
                f"{SCHEMA_VERSION} fields {sorted(HISTOGRAM_FIELDS)} — "
                f"bump SCHEMA_VERSION to change the layout")
            continue
        if not isinstance(h["buckets"], list) or not isinstance(
                h["counts"], list):
            errs.append(f"histograms[{k!r}] buckets/counts must be arrays")
            continue
        if len(h["counts"]) != len(h["buckets"]) + 1:
            errs.append(
                f"histograms[{k!r}] needs len(counts) == len(buckets)+1 "
                f"(overflow bucket), got {len(h['counts'])} vs "
                f"{len(h['buckets'])}")
    return errs


_registry = Registry()


def get_registry() -> Registry:
    """The process-wide registry (what ``--metrics-out`` snapshots)."""
    return _registry


def set_registry(reg: Optional[Registry]) -> Registry:
    """Swap the process-wide registry (tests install a fresh one to assert
    on exact deltas); ``None`` installs a new empty registry."""
    global _registry
    _registry = reg if reg is not None else Registry()
    return _registry
