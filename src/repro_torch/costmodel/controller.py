"""CostController: the mining loop's measured-cost decisions (DESIGN.md §9).

The port's copy of the mining half of the JAX package's controller: the
drivers always build one, calibrate it from every counting job, and ask it

* :meth:`choose_width` — the ``measured`` pass-combining policy;
* :meth:`should_speculate` — whether a count job leaves a window worth
  hiding the next phase's speculative join in.

The mesh, shard-balance, stream re-mine and serving decisions of the
reference arrive with the slices that port those layers.  The port runs on
one device, so the ops basis is the reference's with one data shard and one
candidate shard.

Every decision is appended to :attr:`decisions` — what was predicted, what
was chosen, and (once known) what was measured.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.obs.metrics import get_registry
from repro_torch.obs.trace import current_tracer
from repro_torch.roofline import XFER_OPS_PER_BYTE, count_job_ops

from .measure import device_key
from .model import CostModel, default_model

MAX_DECISIONS = 4096     # telemetry ring: keep the newest decisions


@dataclasses.dataclass
class Decision:
    """One adaptive decision: prediction → choice → (later) measurement."""
    site: str                 # "pass_width" | "speculate"
    key: str                  # cost-model key consulted
    predicted: dict           # option → predicted seconds (or {"cost": x})
    chosen: object            # the decision taken
    measured: float | None = None   # realized seconds, filled by observe_*
    # live view of this decision inside an exported trace (DESIGN.md §13);
    # None when tracing is off
    trace_args: dict | None = dataclasses.field(
        default=None, repr=False, compare=False)

    def as_dict(self) -> dict:
        return {"site": self.site, "key": self.key, "chosen": self.chosen,
                "predicted": {str(k): float(v)
                              for k, v in self.predicted.items()},
                "measured": self.measured}

    def predicted_chosen(self) -> float | None:
        """The predicted cost of the option actually taken (if priced)."""
        for k in (self.chosen, str(self.chosen)):
            if k in self.predicted:
                return float(self.predicted[k])
        return None

    def __setattr__(self, name, value):
        object.__setattr__(self, name, value)
        if name == "measured" and value is not None:
            # observe_* backfills realized cost after the fact; mirror it
            # into the trace event's (shared, mutable) args so exported
            # traces carry predicted-vs-measured residuals
            args = getattr(self, "trace_args", None)
            if args is not None:
                args["measured"] = float(value)
                pred = self.predicted_chosen()
                if pred is not None:
                    args["residual"] = float(value) - pred


class CostController:
    """Decision engine over a (usually shared) :class:`CostModel`.

    Args:
      model: the calibrated fit store; defaults to the process-wide model.
      max_width: widest phase :meth:`choose_width` may pick.
      spec_hide_fraction: speculate only when the predicted in-flight count
        time is at least this fraction of the last measured speculative-join
        cost.
      device: the torch device whose jobs the fits describe (keys the fits;
        ``mine()`` sets it to its runtime's device).
    """

    def __init__(self, model: CostModel | None = None, *, max_width: int = 3,
                 spec_hide_fraction: float = 0.25, device=None):
        self.model = model if model is not None else default_model()
        self.max_width = max(int(max_width), 1)
        self.spec_hide_fraction = spec_hide_fraction
        self.device = device_key(device)
        self.decisions: list[Decision] = []
        # mining count-job context (set by drivers.mine before the loop)
        self._count_impl = "default"
        self._count_txns = 1
        self._count_words = 1
        self._last_spec_seconds: float | None = None

    # -- telemetry -------------------------------------------------------------

    def _record(self, dec: Decision) -> Decision:
        self.decisions.append(dec)
        if len(self.decisions) > MAX_DECISIONS:
            del self.decisions[:len(self.decisions) - MAX_DECISIONS]
        get_registry().counter("costmodel.decisions", site=dec.site).inc()
        tracer = current_tracer()
        if tracer.enabled:
            # the event's args dict stays live: Decision.__setattr__ writes
            # measured/residual into it when observe_* backfills
            args = dec.as_dict()
            pred = dec.predicted_chosen()
            if pred is not None:
                args["predicted_chosen"] = pred
            dec.trace_args = args
            tracer.event(f"decision.{dec.site}", args=args)
        return dec

    def decision_rows(self, since: int = 0) -> list:
        """Decisions (as dicts) appended at index ``since`` or later."""
        return [d.as_dict() for d in self.decisions[since:]]

    # -- count jobs (mining phase loop) ----------------------------------------

    def set_count_context(self, *, n_txns: int, n_words: int,
                          impl: str) -> None:
        """Pin the per-run constants of the counting-ops basis: within one
        mine() run, job work varies only with candidate count."""
        self._count_txns = max(int(n_txns), 1)
        self._count_words = max(int(n_words), 1)
        self._count_impl = impl

    @property
    def count_key(self) -> str:
        return f"{self.device}/{self._count_impl}/count"

    @staticmethod
    def est_count_bytes(n_candidates: float) -> float:
        """Estimated device→host result bytes of one fused counting job:
        the packed keep mask (C/8 bytes) plus filtered int32 counts (4·C)."""
        return 4.125 * max(float(n_candidates), 1.0)

    def _count_ops(self, n_candidates: float,
                   bytes_to_host: float | None = None) -> float:
        """Ops of one counting job: C·T·W word tests, the device→host result
        transfer and the host→device candidate payload (4·W·C bytes)."""
        if bytes_to_host is None:
            bytes_to_host = self.est_count_bytes(n_candidates)
        c = max(int(math.ceil(max(n_candidates, 1))), 1)
        payload = 4.0 * self._count_words * c
        return count_job_ops(c, self._count_txns, self._count_words,
                             bytes_to_host=bytes_to_host) \
            + XFER_OPS_PER_BYTE * payload

    def observe_count(self, n_candidates: int, seconds: float,
                      bytes_to_host: float | None = None) -> None:
        """Calibrate from one completed counting job.  ``bytes_to_host`` is
        the job's measured device→host result traffic; omitted, the fused-job
        estimate keeps observation and prediction in the same basis."""
        self.model.observe(self.count_key,
                           self._count_ops(n_candidates, bytes_to_host),
                           seconds)
        # realized time goes to the newest unmeasured width decision
        for d in reversed(self.decisions):
            if d.site == "pass_width":
                if d.measured is None:
                    d.measured = float(seconds)
                break

    def predict_count(self, n_candidates: int,
                      bytes_to_host: float | None = None) -> float | None:
        return self.model.predict(self.count_key,
                                  self._count_ops(n_candidates,
                                                  bytes_to_host))

    def choose_width(self, prev, prev2) -> float | None:
        """Pick the candidate budget α minimizing predicted cost per level.

        ``prev``/``prev2`` are PhaseStats-shaped (n_candidates,
        n_frequent_last, elapsed).  The chosen α executes with the drivers'
        *budget* semantics — generation stops once the fused phase has spent
        α·|L| candidates.  The levels that budget covers are extrapolated
        from the observed |C| trajectory; minimizing ``(a + b·ops)/levels``
        trades saved job setups against un-pruned counting work.  Returns α,
        or None when the model is uncalibrated (caller falls back to the
        paper's ETDPC table).
        """
        fit = self.model.fit(self.count_key)
        coeffs = fit.coeffs()
        if coeffs is None or prev is None:
            return None
        a, b = coeffs
        c_next = max(prev.n_frequent_last, 1)
        # per-level candidate estimates ĉ_j for the next fused phase
        if prev2 is None:
            # right after Job1: level 2+j of an un-pruned fused phase is
            # exactly C(|L1|, 2+j) candidates
            est = [float(min(math.comb(c_next, 2 + j), 10 ** 15))
                   for j in range(self.max_width)]
        else:
            growth = prev.n_candidates / max(prev2.n_candidates, 1)
            growth = min(max(growth, 0.25), 16.0)
            c0 = max(prev.n_candidates * growth, 1.0)
            est = [c0 * growth ** j for j in range(self.max_width)]
        max_w = self.max_width
        cum = [sum(est[:j + 1]) for j in range(max_w)]
        predicted: dict = {}
        best_w, best_per_level = 1, float("inf")
        for w in range(1, max_w + 1):
            # a fused phase covering w levels counts all of them in one job
            cost = a + b * self._count_ops(cum[w - 1])
            predicted[w] = cost
            if cost / w < best_per_level:
                best_per_level, best_w = cost / w, w
        self._record(Decision("pass_width", self.count_key, predicted,
                              best_w))
        if best_w == 1:
            return 1.0
        # any α with S_{w-2} ≤ α·|L| < S_{w-1} covers w levels; the midpoint
        # is robust to estimate noise on both sides
        alpha = (cum[best_w - 2] + cum[best_w - 1]) / (2.0 * c_next)
        return max(alpha, 1.0)

    # -- speculative-join sizing (drivers) -------------------------------------

    def observe_spec(self, seconds: float) -> None:
        """Record the measured cost of one speculative next-phase join."""
        if seconds > 0:
            self._last_spec_seconds = float(seconds)

    def should_speculate(self, est_candidates: int) -> bool:
        """Speculate only when the predicted count-job time leaves a window
        worth hiding the join in.  Permissive with no calibration or no
        measured join cost yet."""
        predicted = self.predict_count(est_candidates)
        if predicted is None or self._last_spec_seconds is None:
            return True
        ok = predicted >= self.spec_hide_fraction * self._last_spec_seconds
        self._record(Decision(
            "speculate", self.count_key,
            {"count_job": predicted, "join": self._last_spec_seconds}, ok,
            measured=predicted))
        return ok
