"""CostController: measured-cost decisions (DESIGN.md §9).

The port's copy of the JAX package's controller.  The drivers always build
one, calibrate it from every counting job, and ask it

* :meth:`choose_width` — the ``measured`` pass-combining policy;
* :meth:`choose_mesh` — the elastic per-level repartitioning decision
  (DESIGN.md §11): the next fused phase priced under every
  ``(n_data, n_cand)`` factorization of the mesh's cells, a split other
  than the current one charged the measured re-scatter penalty and held to
  a hysteresis margin;
* :meth:`should_rebalance` — the LPT width balance of the database priced
  against its measured host cost;
* :meth:`should_speculate` — whether a count job leaves a window worth
  hiding the next phase's speculative join in;
* :meth:`should_remine` / :meth:`predict_remine` — the streaming miner's
  opportunistic re-mine trigger;
* :meth:`choose_fusion` / :meth:`should_admit` — rule serving's micro-batch
  fusion and SLO admission, and the LM ``ServeEngine``'s decode-step
  fusion (``kind="decode"``, a fit of its own).

Counting-job fits are calibrated in the **per-shard** ops basis: ``ops =
count_job_ops(C/n_cand, T/n_data, W) + transfer`` — the work one cell of
the current mesh performs — so one fit prices alternative splits of the
same job, which is what makes :meth:`choose_mesh` possible.

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
    site: str                 # "pass_width" | "mesh_split" | "rebalance" |
                              # "speculate" | "remine" | "admission" |
                              # "rule_serve_fusion" | "decode_fusion"
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
        self._count_data_shards = 1
        self._count_cand_shards = 1
        self._count_cells = 1
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

    def set_count_context(self, *, n_txns: int, n_words: int, impl: str,
                          n_data_shards: int = 1, n_cand_shards: int = 1,
                          cells_per_device: int = 1) -> None:
        """Pin the per-run constants of the counting-ops basis (DESIGN.md §9):
        within one mine() run at a fixed mesh split, job work varies only
        with candidate count.  The shard counts put observations in the
        per-shard basis (DESIGN.md §11) — call again after a repartition.
        ``cells_per_device`` is the counting cells one device runs in
        sequence (the reference has one device a cell): a device's compute
        is theirs summed, so jobs of any layout share one fit."""
        self._count_txns = max(int(n_txns), 1)
        self._count_words = max(int(n_words), 1)
        self._count_impl = impl
        self._count_data_shards = max(int(n_data_shards), 1)
        self._count_cand_shards = max(int(n_cand_shards), 1)
        self._count_cells = max(int(cells_per_device), 1)

    @property
    def count_key(self) -> str:
        return f"{self.device}/{self._count_impl}/count"

    @staticmethod
    def est_count_bytes(n_candidates: float) -> float:
        """Estimated device→host result bytes of one fused counting job:
        the packed keep mask (C/8 bytes) plus filtered int32 counts (4·C)."""
        return 4.125 * max(float(n_candidates), 1.0)

    def _count_ops(self, n_candidates: float,
                   bytes_to_host: float | None = None,
                   split: tuple[int, int] | None = None) -> float:
        """Per-device ops of one counting job on an ``(n_data, n_cand)`` mesh.

        Compute is C/n_cand candidates against T/n_data transactions for
        each of the device's cells; the device→host result transfer is
        global.  Two transfer terms depend on the split — they make
        equal-product factorizations price differently in
        :meth:`choose_mesh`: the per-cell candidate payload
        (4·W·C/n_cand bytes) and the reduce over ``data`` (≈ 2·(n_data−1)/
        n_data ring all-reduce passes over the per-shard result bytes)."""
        if bytes_to_host is None:
            bytes_to_host = self.est_count_bytes(n_candidates)
        dd, dc = split if split is not None else (
            self._count_data_shards, self._count_cand_shards)
        dd, dc = max(dd, 1), max(dc, 1)
        c_shard = max(int(math.ceil(max(n_candidates, 1) / dc)), 1)
        t_shard = max(self._count_txns // dd, 1)
        payload = 4.0 * self._count_words * c_shard
        psum = 2.0 * (dd - 1) / dd * self.est_count_bytes(c_shard)
        ops = count_job_ops(c_shard, t_shard, self._count_words,
                            bytes_to_host=bytes_to_host)
        if self._count_cells > 1:
            # the device's other cells count in turn
            ops += (self._count_cells - 1) * count_job_ops(
                c_shard, t_shard, self._count_words)
        return ops + XFER_OPS_PER_BYTE * (payload + psum)

    def observe_count(self, n_candidates: int, seconds: float,
                      bytes_to_host: float | None = None) -> None:
        """Calibrate from one completed counting job.  ``bytes_to_host`` is
        the job's measured device→host result traffic; omitted, the fused-job
        estimate keeps observation and prediction in the same basis."""
        self.model.observe(self.count_key,
                           self._count_ops(n_candidates, bytes_to_host),
                           seconds)
        # realized time goes to the newest unmeasured width/mesh decision
        for site in ("pass_width", "mesh_split"):
            for d in reversed(self.decisions):
                if d.site == site:
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

    # -- elastic mesh repartitioning (drivers, DESIGN.md §11) ------------------

    @property
    def repartition_key(self) -> str:
        return f"{self.device}/{self._count_impl}/scatter"

    def observe_repartition(self, n_txns: int, n_words: int,
                            seconds: float) -> None:
        """Calibrate the re-layout penalty from one measured (re-)scatter —
        host re-pack plus device placement, proportional to database bytes."""
        self.model.observe(self.repartition_key,
                           max(int(n_txns), 1) * max(int(n_words), 1), seconds)

    def predict_repartition(self, n_txns: int, n_words: int) -> float | None:
        return self.model.predict(self.repartition_key,
                                  max(int(n_txns), 1) * max(int(n_words), 1))

    def choose_mesh(self, est_candidates: int, *, n_devices: int,
                    current: tuple[int, int] | None = None,
                    hysteresis: float = 0.15) -> tuple[int, int] | None:
        """Pick the ``(n_data, n_cand)`` split minimizing the next fused
        phase's predicted cost (DESIGN.md §11).

        Every factorization of ``n_devices`` cells is priced at the
        per-shard ops the split would give this phase's (C, T) extents.  A
        split other than ``current`` is charged the measured re-scatter
        penalty and must beat the current split by ``hysteresis``
        (fractional) on top of it, so ping-ponging on noise is priced out.
        Returns the chosen split, or None when the model is uncalibrated
        (caller keeps the current mesh).
        """
        if n_devices <= 1:
            return None
        coeffs = self.model.fit(self.count_key).coeffs()
        if coeffs is None:
            return None
        a, b = coeffs
        penalty = self.predict_repartition(self._count_txns,
                                           self._count_words) or 0.0
        predicted: dict = {}
        best, best_t = None, float("inf")
        cur_t = None
        for dd in range(1, n_devices + 1):
            if n_devices % dd:
                continue
            split = (dd, n_devices // dd)
            t = a + b * self._count_ops(est_candidates, split=split)
            predicted[f"{split[0]}x{split[1]}"] = t
            if current is not None and split == current:
                cur_t = t
            elif current is not None:
                t += penalty
            if t < best_t:
                best, best_t = split, t
        if current is not None and best != current and cur_t is not None:
            if best_t > (1.0 - hysteresis) * cur_t:
                best, best_t = current, cur_t     # not worth the re-layout
        self._record(Decision("mesh_split", self.count_key, predicted,
                              f"{best[0]}x{best[1]}"))
        return best

    # -- LPT shard balance (drivers, DESIGN.md §11) ----------------------------

    @property
    def rebalance_key(self) -> str:
        return f"{self.device}/host/rebalance"

    def observe_rebalance(self, n_txns: int, seconds: float) -> None:
        """Calibrate from one measured LPT width-balance re-pack."""
        self.model.observe(self.rebalance_key, max(int(n_txns), 1), seconds)

    def should_rebalance(self, shard_loads, *, est_candidates: int,
                         est_jobs: int = 3) -> bool:
        """Enable the static LPT width balance only when it pays for itself.

        ``shard_loads`` are the per-shard total transaction widths an
        unbalanced contiguous split would produce (the per-mapper work
        proxy).  The predicted straggler waste is the skew fraction
        ``max/mean − 1`` of one predicted counting job, integrated over
        ``est_jobs`` expected jobs; the cost side is the calibrated host
        re-pack time (a cheap O(N log N) estimate until first measured).
        """
        loads = [float(x) for x in shard_loads]
        if len(loads) < 2 or sum(loads) <= 0:
            return False
        mean = sum(loads) / len(loads)
        skew = max(loads) / mean - 1.0
        t_job = self.predict_count(est_candidates)
        if t_job is None:
            return False                    # uncalibrated: keep the default
        waste = skew * t_job * max(int(est_jobs), 1)
        cost = self.model.predict(self.rebalance_key, self._count_txns)
        if cost is None:
            cost = 2e-8 * self._count_txns  # ~numpy argsort+take per row
        fire = waste > cost
        self._record(Decision("rebalance", self.rebalance_key,
                              {"straggler_waste": waste, "rebalance": cost},
                              fire))
        return fire

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

    # -- stream re-mine trigger (StreamMiner) ----------------------------------

    @property
    def remine_key(self) -> str:
        return f"{self.device}/{self._count_impl}/remine"

    def observe_remine(self, window_rows: int, seconds: float) -> None:
        """Calibrate from one completed full re-mine of ``window_rows``."""
        self.model.observe(self.remine_key, max(int(window_rows), 1), seconds)

    def predict_remine(self, window_rows: int) -> float | None:
        """Predicted full-remine seconds at the *current* window size — the
        cold-start fix: a tiny init-time mine no longer freezes the estimate
        (ops basis = window rows, so one sample already extrapolates
        proportionally as the window grows)."""
        return self.model.predict(self.remine_key, max(int(window_rows), 1))

    def should_remine(self, *, drift: float, staleness_seconds: float,
                      window_rows: int, staleness_factor: float,
                      fallback_seconds: float | None = None) -> bool:
        """ETDPC-style opportunistic trigger: re-mine when the accumulated
        delta-path cost, scaled by window churn, exceeds the predicted cost
        of re-mining now."""
        predicted = self.predict_remine(window_rows)
        if predicted is None:
            predicted = fallback_seconds
        if predicted is None or window_rows <= 0:
            return False
        fire = drift * staleness_seconds > staleness_factor * predicted
        self._record(Decision(
            "remine", self.remine_key,
            {"remine": predicted, "accumulated": drift * staleness_seconds},
            fire))
        return fire

    # -- serving micro-batch fusion (RuleServeEngine / ServeEngine) ------------

    def serve_key(self, kind: str = "rule_serve") -> str:
        return f"{self.device}/{kind}/dispatch"

    def observe_serve(self, work_per_unit: float, n_units: int,
                      seconds: float, kind: str = "rule_serve") -> None:
        """Calibrate from one serving dispatch (``n_units`` fused units of
        ``work_per_unit`` ops each — queries·rules·words for rule serving,
        batch rows for decode steps)."""
        self.model.observe(self.serve_key(kind),
                           max(work_per_unit, 1.0) * max(int(n_units), 1),
                           seconds)
        for d in reversed(self.decisions):
            if d.site.endswith("_fusion"):
                if d.measured is None:
                    d.measured = float(seconds)
                break

    def should_admit(self, *, work: float, latency_slo_s: float,
                     backlog_s: float = 0.0,
                     kind: str = "rule_serve") -> tuple[bool, Decision]:
        """SLO admission for one serving query (DESIGN.md §12).

        Predicted sojourn = queue backlog already committed to the device
        (``backlog_s``, virtual busy time ahead of this query) plus the
        calibrated dispatch-time prediction for ``work`` ops.  Admit iff the
        sojourn fits ``latency_slo_s``.  Permissive when uncalibrated — with
        no fit there is no honest prediction, and the first dispatches *are*
        the calibration.  Returns ``(admit, decision)``; the decision is
        recorded under site ``"admission"`` so ``report.py --decisions``
        renders shed telemetry next to mining decisions, and the caller
        backfills ``decision.measured`` with the realized latency.
        """
        key = self.serve_key(kind)
        predicted = (self.model.predict(key, max(work, 1.0))
                     if self.model.n_samples(key) else None)
        if predicted is None:
            dec = self._record(Decision(
                "admission", key, {"slo": latency_slo_s}, True))
            return True, dec
        sojourn = float(backlog_s) + float(predicted)
        admit = sojourn <= latency_slo_s
        dec = self._record(Decision(
            "admission", key,
            {"sojourn": sojourn, "slo": latency_slo_s}, admit))
        return admit, dec

    def choose_fusion(self, *, work_per_unit: float, queued: int,
                      max_fuse: int, latency_budget_s: float | None = None,
                      kind: str = "rule_serve") -> int | None:
        """Units (query batches / decode steps) to fuse into one dispatch.

        With a latency budget: the widest fusion whose predicted dispatch
        time fits the budget (always at least 1 — a budget no single unit
        meets degrades to per-unit dispatch, the honest floor).  Without one:
        fuse maximally — per-unit cost ``(a + b·f·ops)/f`` is non-increasing
        in ``f``, so the only reason to hold back is latency.  Returns None
        when the model is uncalibrated (caller falls back to its policy).
        """
        key = self.serve_key(kind)
        if self.model.n_samples(key) == 0:
            return None
        cap = max(min(int(queued), int(max_fuse)), 1)
        predicted: dict = {}
        chosen = cap
        if latency_budget_s is not None:
            chosen = 1
            for f in range(1, cap + 1):
                t = self.model.predict(key, max(work_per_unit, 1.0) * f)
                predicted[f] = t
                if t is not None and t <= latency_budget_s:
                    chosen = f
        else:
            predicted[cap] = self.model.predict(
                key, max(work_per_unit, 1.0) * cap)
        self._record(Decision(f"{kind}_fusion"
                              if not kind.endswith("_fusion") else kind,
                              key, {str(k): v for k, v in predicted.items()
                                    if v is not None}, chosen))
        return chosen
