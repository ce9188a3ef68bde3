"""CostModel: per-key affine cost fits in the measured-ops basis (DESIGN.md §9).

One :class:`AffineFit` per ``(device, impl, kind)`` key models the cost of a
job as

    t ≈ a + b · ops

with ``ops`` the job's work in the measured-ops basis ``roofline.count_job_ops``
defines (candidate-word comparisons for counting jobs; rule·query·word terms
for serving dispatches; window rows for re-mines).  The affine form is the
whole point: ``a`` is the per-job dispatch/setup overhead — the paper's
"job scheduling cost" that pass combining amortizes — and ``b`` the marginal
per-op counting cost that un-pruned candidates inflate.  Every adaptive
decision is a trade between the two.

Fits are accumulated online from observed timings (running sums — O(1) state
per key, no sample buffer), warm-started from and persisted to a JSON store
beside the autotune cache (``measure.costmodel_store``).  The fits in memory
are authoritative; the store is written behind them, at most once every
``SAVE_INTERVAL_S`` and at exit, so no observation waits on the disk.
Predictions are clamped monotone non-decreasing in ``ops`` (slope ≥ 0) so a
wider phase is never predicted cheaper than a narrower one at equal overhead.

Two defenses keep the fit honest on a live system:

* **decay** — running sums are multiplied by ``DECAY`` per observation
  (effective window ≈ 1/(1−DECAY) samples), so a stale regime (or an early
  bad sample) washes out instead of biasing the fit forever;
* **outlier rejection** — once calibrated, a sample more than
  ``OUTLIER_FACTOR``× the fit's own prediction is dropped: that signature is
  a one-off compile/jit spike, exactly the cost the steady-state model must
  *not* learn (a genuine regime change arrives as many moderate misses,
  which decay absorbs).
"""

from __future__ import annotations

import atexit
import dataclasses
import math
import weakref

from repro_torch.obs.clock import MonotonicClock
from repro_torch.obs.metrics import get_registry
from repro_torch.obs.trace import current_tracer

from .measure import costmodel_store

# fits are noise-level below this many samples; predict() still answers (ratio
# estimate through the origin) but intercept-based overhead() stays None
MIN_AFFINE_SAMPLES = 3
DECAY = 0.9              # per-observation forgetting factor (~10-sample window)
OUTLIER_FACTOR = 8.0     # reject samples this far above the fit's prediction
SAVE_INTERVAL_S = 1.0    # least time between two writes of the store


@dataclasses.dataclass
class AffineFit:
    """Decayed running least-squares state for one cost key.

    ``n`` counts every accepted observation (calibration gating); ``sw`` is
    the *decayed* sample weight Σγⁱ the normal equations use, so the fit
    itself always reflects the recent regime."""
    n: int = 0
    sw: float = 0.0
    sx: float = 0.0
    sy: float = 0.0
    sxx: float = 0.0
    sxy: float = 0.0

    def observe(self, ops: float, seconds: float) -> None:
        x, y = float(ops), float(seconds)
        if not (math.isfinite(x) and math.isfinite(y)) or x <= 0 or y < 0:
            return
        if self.n >= MIN_AFFINE_SAMPLES:
            p = self.predict(x)
            if p is not None and p > 0 and y > OUTLIER_FACTOR * p:
                return              # compile/jit spike, not steady-state cost
        self.n += 1
        # decayed sums: sample weights fall off geometrically with age
        self.sw = DECAY * self.sw + 1.0
        self.sx = DECAY * self.sx + x
        self.sy = DECAY * self.sy + y
        self.sxx = DECAY * self.sxx + x * x
        self.sxy = DECAY * self.sxy + x * y

    def coeffs(self) -> tuple[float, float] | None:
        """(a, b) of t ≈ a + b·ops, clamped to a ≥ 0, b ≥ 0; None if unfit."""
        if self.n == 0 or self.sxx <= 0:
            return None
        ratio_b = max(self.sxy / self.sxx, 0.0)
        if self.n < MIN_AFFINE_SAMPLES:
            return (0.0, ratio_b)       # through-origin ratio estimate
        denom = self.sw * self.sxx - self.sx * self.sx
        if denom <= 0:                  # all samples at one ops value
            return (0.0, ratio_b)
        b = (self.sw * self.sxy - self.sx * self.sy) / denom
        a = (self.sy - b * self.sx) / self.sw
        if b < 0:                       # noise-dominated: keep monotonicity
            return (0.0, ratio_b)
        return (max(a, 0.0), b)

    def predict(self, ops: float) -> float | None:
        c = self.coeffs()
        if c is None:
            return None
        a, b = c
        return a + b * float(ops)

    def as_dict(self) -> dict:
        return {"n": self.n, "sw": self.sw, "sx": self.sx, "sy": self.sy,
                "sxx": self.sxx, "sxy": self.sxy}

    @classmethod
    def from_dict(cls, d: dict) -> "AffineFit":
        try:
            return cls(n=int(d["n"]), sw=float(d["sw"]), sx=float(d["sx"]),
                       sy=float(d["sy"]), sxx=float(d["sxx"]),
                       sxy=float(d["sxy"]))
        except (KeyError, TypeError, ValueError):
            return cls()


class CostModel:
    """Calibrated per-key cost predictor.

    Args:
      persist: warm-start fits from the store (``measure.costmodel_store``,
        bound when the model is made) and write them back behind the
        observations: an observation writes the store only where
        ``SAVE_INTERVAL_S`` has passed since this model's last write (the
        first writes at once), :meth:`flush` writes what is newer, and every
        live persisting model is flushed at interpreter exit.  So the store
        lags the fits in memory by at most a second of observations; a
        process killed by a signal, or a model dropped before exit, loses
        that second.  Tests and benchmarks that need a clean slate pass
        ``persist=False``.
      clock: the write-behind's time source (``now() -> float`` seconds,
        DESIGN.md §13); default the monotonic wall clock.
    """

    SCHEMA = 2   # v2: decayed-weight fits (sw field); v1 stores are discarded

    def __init__(self, persist: bool = True, *, clock=None):
        self.persist = persist
        self._fits: dict[str, AffineFit] = {}
        self._clock = clock if clock is not None else MonotonicClock()
        self._dirty = False
        self._saved_at: float | None = None     # clock time of the last write
        self._store = costmodel_store() if persist else None
        if persist:
            disk = self._store.load()
            if disk.get("schema") == self.SCHEMA:
                for key, d in disk.get("fits", {}).items():
                    self._fits[key] = AffineFit.from_dict(d)
            _persisting.add(self)

    def fit(self, key: str) -> AffineFit:
        if key not in self._fits:
            self._fits[key] = AffineFit()
        return self._fits[key]

    def observe(self, key: str, ops: float, seconds: float) -> None:
        self.fit(key).observe(ops, seconds)
        if self.persist:
            get_registry().counter("costmodel.observations").inc()
            self._dirty = True
            if (self._saved_at is None or
                    self._clock.now() - self._saved_at >= SAVE_INTERVAL_S):
                self._save(key=key)

    def flush(self) -> None:
        """Write the store now if an observation is newer than its last
        write (a no-op without ``persist``)."""
        if self._dirty:
            self._save()

    def _save(self, **attrs) -> None:
        # cleared before the fits are read: an observation made meanwhile
        # leaves the model dirty for the next write
        self._dirty = False
        with current_tracer().span("costmodel.save", **attrs):
            self._store.save(
                {"schema": self.SCHEMA,
                 "fits": {k: f.as_dict() for k, f in self._fits.items()}})
        self._saved_at = self._clock.now()
        get_registry().counter("costmodel.saves").inc()

    def predict(self, key: str, ops: float) -> float | None:
        """Predicted job seconds, or None when the key has no samples."""
        f = self._fits.get(key)
        return f.predict(ops) if f is not None else None

    def overhead(self, key: str) -> float | None:
        """Per-job fixed overhead (the fitted intercept ``a``), or None when
        the key lacks enough samples for an affine (vs ratio) fit."""
        f = self._fits.get(key)
        if f is None or f.n < MIN_AFFINE_SAMPLES:
            return None
        c = f.coeffs()
        return c[0] if c is not None else None

    def n_samples(self, key: str) -> int:
        f = self._fits.get(key)
        return f.n if f is not None else 0


_default: CostModel | None = None
# every live persisting model, flushed at exit; weak, so a model dropped
# (as tests drop ``_default``) is not kept alive for it
_persisting: "weakref.WeakSet[CostModel]" = weakref.WeakSet()


@atexit.register
def _flush_at_exit() -> None:
    for model in list(_persisting):
        model.flush()


def default_model() -> CostModel:
    """Process-wide shared model: every decision site calibrates the same
    fits, which is what makes the controller *one* controller."""
    global _default
    if _default is None:
        _default = CostModel()
    return _default
