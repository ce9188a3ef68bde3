"""SLO-aware admission, fair shedding, and result caching for rule serving
(DESIGN.md §12): the port's copy of the JAX package's
``serving/admission.py``, pure Python over the port's ``obs`` and cost model.

The closed-loop benchmark arms answer "how fast can the engine go"; this
module answers the production question — "what traffic can it sustain *while
meeting a latency SLO*".  Three mechanisms, layered in the order a query
meets them:

1. **Result cache** (:class:`ResultCache`): an LRU over
   ``(tenant, rule_version, frozen-basket, k)``.  Hot baskets skip the device
   entirely (outcome ``"cached"``, zero queueing).  Keying on the tenant's
   RuleStore *version counter* makes invalidation atomic and free: a
   :meth:`~repro_torch.serving.rule_store.RuleStore.swap_rules` bumps the version,
   every stale entry simply stops being reachable, and other tenants' cached
   answers survive untouched.

2. **SLO admission** (:meth:`~repro_torch.costmodel.CostController.should_admit`):
   predicted sojourn — device backlog already committed plus the calibrated
   cost-model prediction for the dispatch this query would join — against the
   ``latency_slo_ms`` target.  A query that would blow the SLO anyway is shed
   *on arrival* (outcome ``"shed"``), which is cheaper for everyone than
   serving it late: under overload, queueing theory says the queue otherwise
   grows without bound and every tenant misses.

3. **Fair shedding**: overload shedding alone lets one tenant's burst starve
   the rest.  When an arrival must shed but its tenant is *under* its fair
   share (1/n_active of admitted traffic), the newest queued query of the
   most over-share tenant is displaced instead — per-tenant max-min fairness
   with O(queue) bookkeeping, no token buckets.

The :class:`OpenLoopServer` drives all three under an **open-loop virtual
clock**: queries carry synthetic arrival timestamps, the device is a single
virtual resource (``busy_until``), and a dispatch's cost is either the real
measured serve time (benchmark mode) or a scripted ``dispatch_cost_fn``
(tier-1 tests — fully deterministic, no sleeps, no wall clock in the latency
math).  Latency = completion − arrival, so queueing delay is priced in, which
is exactly what the closed-loop arms hide.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

from repro_torch.obs.clock import MonotonicClock
from repro_torch.obs.metrics import Registry
from repro_torch.obs.trace import current_tracer
from repro_torch.roofline import XFER_OPS_PER_BYTE

from .rule_store import DEFAULT_TENANT


def basket_key(basket) -> tuple:
    """Canonical cache key for one basket: sorted de-duplicated item ids
    (bitset packing is set-semantics, so order/multiplicity never matter)."""
    return tuple(sorted(set(int(i) for i in basket)))


class ResultCache:
    """LRU result cache keyed by (tenant, rule version, basket, k).

    ``capacity <= 0`` disables caching (every get misses, puts are dropped).
    Entries for superseded rule versions are unreachable by construction —
    lookups always use the *current* version — and get evicted by LRU churn,
    so a swap invalidates a tenant's answers atomically without a scan.
    """

    def __init__(self, capacity: int = 256, registry: Registry | None = None):
        self.capacity = int(capacity)
        self._data: OrderedDict = OrderedDict()
        # hit/miss telemetry lives in a metrics registry (DESIGN.md §13);
        # a private one by default so unrelated caches never share counts
        self._metrics = registry if registry is not None else Registry()
        self._hits = self._metrics.counter("serving.cache_hits")
        self._misses = self._metrics.counter("serving.cache_misses")

    @property
    def hits(self) -> int:
        return int(self._hits.value)

    @property
    def misses(self) -> int:
        return int(self._misses.value)

    def __len__(self) -> int:
        return len(self._data)

    def get(self, tenant: str, version: int, basket, k: int):
        if self.capacity <= 0:
            return None
        key = (tenant, version, basket_key(basket), k)
        if key not in self._data:
            self._misses.inc()
            return None
        self._data.move_to_end(key)
        self._hits.inc()
        return self._data[key]

    def put(self, tenant: str, version: int, basket, k: int, recs) -> None:
        if self.capacity <= 0:
            return
        key = (tenant, version, basket_key(basket), k)
        self._data[key] = recs
        self._data.move_to_end(key)
        while len(self._data) > self.capacity:
            self._data.popitem(last=False)


@dataclasses.dataclass
class QueryOutcome:
    """What happened to one submitted query — the admission telemetry row."""
    seq: int
    tenant: str
    t_arrival: float
    outcome: str = "queued"       # → "served" | "cached" | "shed"
    t_done: float | None = None
    latency_s: float | None = None
    dispatch_idx: int | None = None
    n_fused: int | None = None    # queries fused into the answering dispatch
    results: list | None = dataclasses.field(default=None, repr=False)

    def as_dict(self) -> dict:
        return {"seq": self.seq, "tenant": self.tenant,
                "t_arrival": self.t_arrival, "outcome": self.outcome,
                "latency_ms": (None if self.latency_s is None
                               else self.latency_s * 1e3),
                "dispatch_idx": self.dispatch_idx, "n_fused": self.n_fused}


@dataclasses.dataclass
class _Pending:
    outcome: QueryOutcome
    basket: tuple
    decision: object | None       # admission Decision to backfill .measured
    t_submit: float               # the server's clock at submit


class OpenLoopServer:
    """Open-loop admission front-end over a :class:`RuleServeEngine`.

    Queries arrive with explicit timestamps (:meth:`submit`); the server
    caches / admits / sheds each one, micro-batches admitted queries, and
    advances a virtual device clock per dispatch.  Deterministic by
    construction: with a scripted ``dispatch_cost_fn`` no wall-clock value
    enters any latency, so tier-1 load tests assert exact numbers.

    Args:
      engine: the (single- or multi-tenant) RuleServeEngine to dispatch on.
      latency_slo_ms: admission target; None disables shedding (admit all).
      batch: dispatch when this many queries are queued.
      max_wait_ms: dispatch when the oldest queued query has waited this
        long (bounds tail latency under light load).
      cache_size: LRU entries (0 disables the result cache).
      fair_shedding: displace over-share tenants instead of shedding an
        under-share arrival.
      controller: CostController for admission predictions + telemetry;
        defaults to the engine's (admission needs one — without any, all
        queries are admitted).
      dispatch_cost_fn: ``(n_queries, work_ops) -> seconds`` override for the
        virtual dispatch cost; None measures the real serve call.
      top_k: recommendations per query (default: engine top_k).
      clock: injectable clock (DESIGN.md §13) for the *real* dispatch-cost
        measurement; default :class:`~repro_torch.obs.clock.MonotonicClock`, tests
        pass :class:`~repro_torch.obs.clock.FakeClock`.  (The latency math itself
        runs on the virtual arrival clock regardless.)
      registry: metrics registry fed with per-tenant offered/admitted/shed
        counters and latency histograms; default a private
        :class:`~repro_torch.obs.metrics.Registry` so concurrent servers never
        share fair-shedding accounting.  CLIs pass the process-wide one.
    """

    def __init__(self, engine, *, latency_slo_ms: float | None = None,
                 batch: int = 8, max_wait_ms: float = 5.0,
                 cache_size: int = 256, fair_shedding: bool = True,
                 controller=None, dispatch_cost_fn=None,
                 top_k: int | None = None, clock=None,
                 registry: Registry | None = None):
        self.engine = engine
        self.latency_slo_s = (None if latency_slo_ms is None
                              else float(latency_slo_ms) / 1e3)
        self.batch = max(int(batch), 1)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.clock = clock if clock is not None else MonotonicClock()
        self.metrics = registry if registry is not None else Registry()
        self.cache = ResultCache(cache_size, registry=self.metrics)
        self.fair_shedding = fair_shedding
        self.controller = (controller if controller is not None
                           else getattr(engine, "controller", None))
        self.dispatch_cost_fn = dispatch_cost_fn
        self.top_k = top_k
        self.busy_until = 0.0
        self.outcomes: list[QueryOutcome] = []
        self.dispatches = 0
        self._queue: list[_Pending] = []
        self._seq = 0
        self._tenants: list[str] = []    # insertion-ordered active tenants

    # -- work accounting (same ops basis as the engine, DESIGN.md §10) ---------

    def _per_query_work(self, state) -> float:
        eng = self.engine
        n_rules = len(state)
        k = max(min(eng.top_k if self.top_k is None else self.top_k,
                    n_rules), 0)
        kf = (min(k * eng.overfetch, n_rules)
              if eng.dedup_consequents else k)
        return float(n_rules) * state.W + 8.0 * kf * XFER_OPS_PER_BYTE

    # -- ingress ---------------------------------------------------------------

    def submit(self, basket, t_arrival: float,
               tenant: str = DEFAULT_TENANT) -> QueryOutcome:
        """Offer one query at virtual time ``t_arrival`` (non-decreasing), in
        a ``serve.submit`` span whose ``outcome`` is the query's on return."""
        with current_tracer().span("serve.submit") as span:
            out = self._submit(basket, t_arrival, tenant)
            span.set(outcome=out.outcome)
        return out

    def _submit(self, basket, t_arrival: float, tenant: str) -> QueryOutcome:
        t_submit = self.clock.now()
        self._pump(t_arrival)
        out = QueryOutcome(self._seq, tenant, float(t_arrival))
        self._seq += 1
        self.outcomes.append(out)
        self._seen(tenant)

        # 1) cache fast-path: zero latency, no device work
        version = self.engine.store.version(tenant)
        k = self.top_k if self.top_k is not None else self.engine.top_k
        hit = self.cache.get(tenant, version, basket, k)
        if hit is not None:
            out.outcome = "cached"
            out.t_done = out.t_arrival
            out.latency_s = 0.0
            out.results = hit
            self._count(tenant, "admitted")
            self.metrics.histogram("serving.latency_ms",
                                   tenant=tenant).observe(0.0)
            current_tracer().add_span(
                "serve.query", out.t_arrival, out.t_arrival, tid="queries",
                tenant=tenant, outcome="cached", seq=out.seq)
            return out

        # 2) SLO admission against predicted sojourn
        dec = None
        if self.latency_slo_s is not None and self.controller is not None:
            state = self.engine.store.state
            backlog = max(self.busy_until - out.t_arrival, 0.0)
            work = self._per_query_work(state) * (len(self._queue) + 1)
            admit, dec = self.controller.should_admit(
                work=work, backlog_s=backlog,
                latency_slo_s=self.latency_slo_s)
            if not admit and not self._try_displace(tenant):
                out.outcome = "shed"
                dec.measured = 0.0
                self._count(tenant, "shed")
                current_tracer().add_span(
                    "serve.query", out.t_arrival, out.t_arrival,
                    tid="queries", tenant=tenant, outcome="shed",
                    seq=out.seq)
                return out

        self._queue.append(_Pending(out, tuple(basket), dec, t_submit))
        self._count(tenant, "admitted")
        if len(self._queue) >= self.batch:
            self._dispatch_group(t_arrival)
        return out

    def flush(self, now: float | None = None) -> None:
        """Drain every queued query (end of the arrival stream)."""
        while self._queue:
            t = self._queue[-1].outcome.t_arrival
            self._dispatch_group(t if now is None else max(now, t))

    # -- internals -------------------------------------------------------------

    def _seen(self, tenant: str) -> None:
        if tenant not in self._tenants:
            self._tenants.append(tenant)
        self._count(tenant, "offered")

    def _count(self, tenant: str, what: str, n: float = 1) -> None:
        self.metrics.counter(f"serving.{what}", tenant=tenant).inc(n)

    def _tenant_n(self, tenant: str, what: str) -> float:
        return self.metrics.value(f"serving.{what}", tenant=tenant)

    def _try_displace(self, tenant: str) -> bool:
        """Fair shedding: if ``tenant`` is under its fair share of admitted
        traffic, displace the newest queued query of the most over-share
        tenant (≠ this one) and admit the arrival in its place."""
        if not self.fair_shedding or not self._queue:
            return False
        active = [t for t in self._tenants if self._tenant_n(t, "offered") > 0]
        if len(active) < 2:
            return False
        admitted = {t: self._tenant_n(t, "admitted") for t in self._tenants}
        fair = sum(admitted.values()) / len(active)
        if admitted[tenant] >= fair:
            return False
        heavy = max((t for t in active if t != tenant),
                    key=lambda t: admitted[t], default=None)
        if heavy is None or admitted[heavy] <= fair:
            return False
        for i in range(len(self._queue) - 1, -1, -1):
            p = self._queue[i]
            if p.outcome.tenant == heavy:
                del self._queue[i]
                p.outcome.outcome = "shed"
                if p.decision is not None:
                    p.decision.measured = 0.0
                self._count(heavy, "admitted", -1)   # admission revoked
                self._count(heavy, "shed")
                current_tracer().add_span(
                    "serve.query", p.outcome.t_arrival,
                    p.outcome.t_arrival, tid="queries", tenant=heavy,
                    outcome="shed", displaced=True, seq=p.outcome.seq)
                return True
        return False

    def _pump(self, now: float) -> None:
        """Fire the age trigger: dispatch once the oldest queued query has
        waited ``max_wait_s`` of virtual time."""
        while self._queue and (now - self._queue[0].outcome.t_arrival
                               >= self.max_wait_s):
            ready = self._queue[0].outcome.t_arrival + self.max_wait_s
            self._dispatch_group(min(ready, now))

    def _dispatch_group(self, now: float) -> None:
        group = self._queue[:self.batch]
        del self._queue[:len(group)]
        if not group:
            return
        tracer = current_tracer()
        with tracer.span("serve.batch", n_queries=len(group)) as span:
            if tracer.enabled:
                t = self.clock.now()
                span.set(wait_s=[t - p.t_submit for p in group])
            self._serve_group(group, now)

    def _serve_group(self, group: list, now: float) -> None:
        state = self.engine.store.state
        pairs = [(p.outcome.tenant, p.basket) for p in group]
        versions = {p.outcome.tenant:
                    state.versions.get(p.outcome.tenant, 0) for p in group}

        t0 = self.clock.now()
        results, records = self.engine.serve([pairs], top_k=self.top_k)
        real = self.clock.now() - t0
        per_query = self._per_query_work(state)
        work = per_query * len(group)
        cost = (real if self.dispatch_cost_fn is None
                else float(self.dispatch_cost_fn(len(group), work)))

        start = max(now, self.busy_until)
        done = start + cost
        self.busy_until = done
        idx = self.dispatches
        self.dispatches += 1

        # scripted runs calibrate from the scripted cost; real runs leave
        # calibration to the engine's own controller hook (no double counts)
        if self.controller is not None and (
                self.dispatch_cost_fn is not None
                or getattr(self.engine, "controller", None) is None):
            self.controller.observe_serve(per_query, len(group), cost)

        tracer = current_tracer()
        tracer.add_span("serve.dispatch", start, done, tid="device",
                        dispatch=idx, n_queries=len(group), cost_s=cost)
        for p, recs in zip(group, results[0]):
            out = p.outcome
            out.outcome = "served"
            out.t_done = done
            out.latency_s = done - out.t_arrival
            out.dispatch_idx = idx
            out.n_fused = len(group)
            out.results = recs
            if p.decision is not None:
                p.decision.measured = out.latency_s
            self.metrics.histogram(
                "serving.latency_ms",
                tenant=out.tenant).observe(out.latency_s * 1e3)
            tracer.add_span(
                "serve.query", out.t_arrival, done, tid="queries",
                tenant=out.tenant, outcome="served", seq=out.seq,
                queue_wait_ms=(start - out.t_arrival) * 1e3,
                dispatch=idx, n_fused=len(group))
            k = self.top_k if self.top_k is not None else self.engine.top_k
            self.cache.put(out.tenant, versions[out.tenant], p.basket, k,
                           recs)

    # -- reporting -------------------------------------------------------------

    def summary(self) -> dict:
        from .common import outcome_summary
        s = outcome_summary(self.outcomes)
        s["dispatches"] = self.dispatches
        s["cache"] = {"hits": self.cache.hits, "misses": self.cache.misses,
                      "entries": len(self.cache)}
        # derived headline gauges for the metrics snapshot (DESIGN.md §13)
        answered = s["served"] + s["cached"]
        self.metrics.gauge("serving.shed_rate").set(s["shed_rate"])
        self.metrics.gauge("serving.cache_hit_rate").set(s["cache_hit_rate"])
        self.metrics.gauge("serving.qps").set(
            answered / max(self.busy_until, 1e-9))
        return s
