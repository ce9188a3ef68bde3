"""Batched association-rule serving — the mine → rules → serve endgame
(DESIGN.md §7, multi-tenant since §12): the port of the JAX package's
``serving/rules_engine.py``.

Incoming basket queries are bit-packed into transaction bitsets (§2) and
matched against rule antecedents with the same word-parallel ``(c & t) == c``
containment test the counting kernels use — ``kernels/rule_match.py`` holds
the CUDA kernels and their plain versions.  Each dispatch computes the
masked (Q, R) confidence·lift score matrix on the device and reduces it with
a top-k there (:func:`stable_top_k`); only the (Q, k) winners cross back to
the host.

Micro-batching: queued query batches are fused per dispatch by the same
pass-combining ``Policy`` objects the mining drivers use
(``core/policy.py``): one dispatch answering ``npass`` queued batches is the
serving analogue of one counting job covering ``npass`` Apriori levels.  The
SPC policy reproduces strict per-batch dispatch; ``measured`` asks the
:class:`~repro_torch.costmodel.CostController`.

Multi-tenant serving: the engine sits on a
:class:`~repro_torch.serving.rule_store.RuleStore` — a tenant registry of
versioned RuleSets packed into one device-resident arena — so one fused
dispatch serves mixed-tenant query batches; per-tenant tag bits in the
packed baskets keep isolation inside the unchanged containment test.

Live rule refresh: :meth:`RuleServeEngine.swap_rules` replaces the store's
whole :class:`~repro_torch.serving.rule_store.ArenaState` with a single
reference assignment.  A serve call captures the state once, so in-flight
queries never observe a half-swapped ("torn") rule table.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.bitset import to_device_words
from repro_torch.core.mapreduce import resolve_device
from repro_torch.core.policy import ALGORITHMS, PhaseStats
from repro_torch.core.rules import RuleSet
from repro_torch.kernels.rule_match import rule_scores, rule_scores_matmul
from repro_torch.obs.trace import current_tracer
from repro_torch.roofline import XFER_OPS_PER_BYTE

from .common import MIN_QUERY_BUCKET, bucket_rows
from .rule_store import DEFAULT_TENANT, ArenaState, RuleStore

RULE_IMPLS = ("auto", "jnp", "matmul")
_SCORERS = {"jnp": rule_scores, "matmul": rule_scores_matmul}


@dataclasses.dataclass(frozen=True)
class Recommendation:
    consequent: tuple       # item ids the rule recommends
    confidence: float       # exact float64, from the RuleSet's integer counts
    lift: float
    score: float            # float32 confidence·lift rank key (device value)


@dataclasses.dataclass
class RuleServeRecord:
    phase_idx: int
    n_batches: int          # queued query batches fused into this dispatch
    n_queries: int
    elapsed: float


def as_tenant_pairs(batch, tenant: str | None = None) -> list:
    """Normalize one query batch to ``(tenant, basket)`` pairs.

    ``tenant`` (when given) applies to every query; otherwise a 2-tuple whose
    first element is a str is already a pair and a bare basket gets
    :data:`DEFAULT_TENANT`.
    """
    if tenant is not None:
        return [(tenant, basket) for basket in batch]
    out = []
    for q in batch:
        if (isinstance(q, tuple) and len(q) == 2
                and isinstance(q[0], str)):
            out.append(q)
        else:
            out.append((DEFAULT_TENANT, q))
    return out


def stable_top_k(scores: torch.Tensor, k: int):
    """The ``k`` largest entries of each row, largest first, equal values
    lowest index first — ``jax.lax.top_k``'s order, which ``torch.topk``
    does not promise.

    Each float32 score becomes a 64-bit key that sorts like it — its bits
    as an int32 with the magnitude bits of negative values flipped — in the
    high half, and ``R − 1 − index`` in the low half.  The keys are unique,
    so ``torch.topk`` over them has one answer: the reference's.  Returns
    ``(values (Q, k) float32, indices (Q, k) int64)``.
    """
    R = scores.shape[1]
    bits = scores.contiguous().view(torch.int32).to(torch.int64)
    order = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    rank = torch.arange(R - 1, -1, -1, dtype=torch.int64,
                        device=scores.device)
    keys = order * (1 << 32) + rank
    top = torch.topk(keys, k, dim=1).values
    idx = (R - 1) - (top & 0xFFFFFFFF)
    return torch.gather(scores, 1, idx), idx


class RuleServeEngine:
    """Answer basket queries with top-k rule consequents by confidence·lift.

    Args:
      rules: a RuleSet from ``core.rules.generate_ruleset`` (wrapped in a
        single-tenant :class:`RuleStore` on ``device``), or a RuleStore on
        ``device`` for multi-tenant serving through the packed arena.
      top_k: default number of recommendations per query.
      impl: one of ``RULE_IMPLS`` — the scoring family: "jnp" (the popcount
        kernel) or "matmul" (the bit-plane kernel); "auto" is "matmul" on a
        card and "jnp" on the CPU, the reference's static choice off the TPU
        (autotuning the choice is not ported yet).
      algorithm: pass-combining policy fusing queued query batches per
        dispatch (core/policy.py; "spc" = strict per-batch dispatch).
      max_fuse: cap on batches fused into one dispatch.
      exclude_contained: drop rules whose consequent the basket already
        contains (nothing new to recommend) — fused into the scoring kernel.
      dedup_consequents: return k *distinct* consequents per query (several
        rules can share one); the device top-k overfetches ``overfetch``×k
        rule slots and the host decode keeps each consequent's best-scoring
        hit.  False returns raw rule-level top-k.
      overfetch: rule slots fetched per requested consequent when deduping
        (clamped to the rule count).
      latency_budget_ms: per-dispatch latency budget for the ``measured``
        algorithm — fuse the most batches whose predicted dispatch time
        stays under it (None: fuse maximally, pure throughput).
      controller: :class:`repro_torch.costmodel.CostController` for the
        ``measured`` algorithm's fusion decisions; default shares the
        process-wide model.
      device: "cuda" (default; raises without a card) or "cpu" (the
        kernels' plain versions).  A RuleStore passed as ``rules`` must live
        there.
    """

    def __init__(self, rules: RuleSet | RuleStore, *, top_k: int = 5,
                 impl: str = "auto", algorithm: str = "optimized_vfpc",
                 policy_kwargs: dict | None = None, max_fuse: int = 16,
                 exclude_contained: bool = True,
                 dedup_consequents: bool = True, overfetch: int = 8,
                 latency_budget_ms: float | None = None,
                 controller=None, device="cuda"):
        if impl not in RULE_IMPLS:
            raise ValueError(
                f"unknown impl {impl!r}; options: {RULE_IMPLS} — the port "
                f"has two rule-scoring families, 'jnp' (popcount kernel) and "
                f"'matmul' (bit-plane kernel)")
        if algorithm not in ALGORITHMS:
            raise ValueError(
                f"unknown algorithm {algorithm!r}; options: {sorted(ALGORITHMS)}")
        self.device = resolve_device(device)
        self.impl = impl
        self.family = ({"cuda": "matmul"}.get(self.device.type, "jnp")
                       if impl == "auto" else impl)
        self.top_k = top_k
        self.max_fuse = max_fuse
        self.exclude_contained = exclude_contained
        self.dedup_consequents = dedup_consequents
        self.overfetch = max(int(overfetch), 1)
        self.algorithm = algorithm
        self.latency_budget_s = (None if latency_budget_ms is None
                                 else float(latency_budget_ms) / 1e3)
        if algorithm == "measured":
            # cost-model fusion: no Policy object — choose_fusion is the
            # serving primitive (DESIGN.md §9)
            if controller is None:
                from repro_torch.costmodel import CostController
                controller = CostController()
            self.policy = None
        else:
            policy_cls, _ = ALGORITHMS[algorithm]
            self.policy = policy_cls(**(policy_kwargs or {}))
        # a controller passed alongside a paper policy still observes every
        # dispatch, so baseline runs calibrate the model the measured mode uses
        self.controller = controller

        if isinstance(rules, RuleStore):
            if rules.device != self.device:
                raise ValueError(f"the store lives on {rules.device}, the "
                                 f"engine on {self.device}")
            self.store = rules
        else:
            self.store = RuleStore(rules, device=self.device)
        self.records: list[RuleServeRecord] = []

    @property
    def rules(self) -> RuleSet:
        return self.store.state.rules          # sole tenant (raises if many)

    @property
    def n_rules(self) -> int:
        return len(self.store.state)

    @property
    def tenants(self) -> tuple:
        return self.store.tenants

    @property
    def dispatches(self) -> int:
        return len(self.records)

    # -- live refresh ----------------------------------------------------------

    def swap_rules(self, rules: RuleSet, warm_to: int | None = None,
                   tenant: str | None = None) -> None:
        """Atomically replace one tenant's served RuleSet.

        The complete successor arena (device tensors, metric columns) is
        built first — optionally warmed with one dispatch per query bucket up
        to ``warm_to`` queries, so the first post-swap dispatch pays no
        kernel build or first launch — and then published with one reference
        assignment.  Serve calls capture the state once, so a query stream
        never sees a torn table.  ``tenant`` defaults to the sole registered
        tenant.
        """
        if tenant is None:
            names = self.store.tenants
            tenant = names[0] if len(names) == 1 else DEFAULT_TENANT
        warm = ((lambda state: self._warm(state, warm_to, self.top_k))
                if warm_to else None)
        self.store.swap_rules(tenant, rules, warm=warm)

    # -- device dispatch -------------------------------------------------------

    def _dispatch(self, state: ArenaState, packed: np.ndarray, k: int):
        """(Q, W) packed baskets → host (Q, k) score values + rule indices:
        the scoring kernel over the arena, then the top-k of the first Q
        rows (the rest are bucket padding)."""
        Q = packed.shape[0]
        Qp = bucket_rows(Q)
        if Qp != Q:
            packed = np.concatenate(
                [packed, np.zeros((Qp - Q, state.W), np.uint32)], axis=0)
        s = _SCORERS[self.family](state.d_ante, state.d_cons, state.d_scores,
                                  to_device_words(packed, state.device),
                                  exclude_contained=self.exclude_contained)
        vals, idx = stable_top_k(s[:Q], k)
        return vals.cpu().numpy(), idx.cpu().numpy()

    def _warm(self, state: ArenaState, max_queries: int,
              top_k: int | None = None):
        k = max(min(self.top_k if top_k is None else top_k, len(state)), 0)
        if k == 0:
            return
        kf = min(k * self.overfetch, len(state)) if self.dedup_consequents else k
        b = MIN_QUERY_BUCKET
        while True:
            self._dispatch(state, np.zeros((b, state.W), np.uint32), kf)
            if b >= max_queries:
                break
            b *= 2

    def warmup(self, max_queries: int, top_k: int | None = None):
        """Dispatch once at every pow2 query bucket up to ``max_queries`` so
        no dispatch in the serving loop pays the kernel build, the first
        launch or the allocator's first request for its shape."""
        self._warm(self.store.state, max_queries, top_k)

    # -- host driver -----------------------------------------------------------

    def _decode(self, state: ArenaState, vals: np.ndarray, idx: np.ndarray,
                k: int):
        dedup = self.dedup_consequents
        out = []
        for q in range(vals.shape[0]):
            recs = []
            seen: set = set()
            for j in range(vals.shape[1]):
                # -inf is the kernel's no-match sentinel; +inf is a legal score
                # (legacy missing-consequent lift) and must decode normally
                if np.isneginf(vals[q, j]) or len(recs) >= k:
                    break
                r = int(idx[q, j])
                cons = state.cons_tuple(r)
                if dedup:
                    if cons in seen:
                        continue    # a lower-scored rule for the same consequent
                    seen.add(cons)
                recs.append(Recommendation(
                    cons, float(state.conf64[r]), float(state.lift64[r]),
                    float(vals[q, j])))
            out.append(recs)
        return out

    def serve(self, batches, top_k: int | None = None,
              tenant: str | None = None):
        """Answer a queue of basket batches with policy-fused dispatches.

        Args:
          batches: sequence of batches; each batch is a list of queries — a
            query is a basket (iterable of item ids, served under the
            default tenant) or a ``(tenant, basket)`` pair; mixed-tenant
            batches share one fused arena dispatch.
          top_k: recommendations per query (default: engine top_k).
          tenant: serve every query under this tenant (overrides pairs).

        Returns ``(results, records)`` — ``results[b][q]`` is the list of
        :class:`Recommendation` for basket ``q`` of batch ``b``, and
        ``records`` the per-dispatch :class:`RuleServeRecord` trace (also kept
        on ``self.records``).
        """
        state = self.store.state     # snapshot: one consistent table per call
        n_rules = len(state)
        k = max(min(self.top_k if top_k is None else top_k, n_rules), 0)
        batches = [as_tenant_pairs(b, tenant) for b in batches]
        results: list = []
        records: list[RuleServeRecord] = []
        history: list[PhaseStats] = []
        if n_rules == 0 or k == 0:            # no rules: everything is empty
            results = [[[] for _ in b] for b in batches]
            self.records = records
            return results, records

        i, phase_idx = 0, 0
        while i < len(batches):
            if self.policy is None:   # measured: predicted latency vs budget
                # per-query work: rule·word containment tests plus the top-k
                # result transfer (8 B per fetched rule slot) in the shared
                # ops basis (roofline.XFER_OPS_PER_BYTE, DESIGN.md §10)
                kf_est = (min(k * self.overfetch, n_rules)
                          if self.dedup_consequents else k)
                per_query = (float(n_rules) * state.W
                             + 8.0 * kf_est * XFER_OPS_PER_BYTE)
                work = per_query * max(len(batches[i]), 1)
                nfuse = self.controller.choose_fusion(
                    work_per_unit=work, queued=len(batches) - i,
                    max_fuse=self.max_fuse,
                    latency_budget_s=self.latency_budget_s)
                # uncalibrated: dispatch one batch — it is the calibration
                nfuse = 1 if nfuse is None else int(nfuse)
            else:
                prev = history[-1] if history else None
                prev2 = history[-2] if len(history) > 1 else None
                mode, val = self.policy.decide(prev, prev2)
                if mode == "width":
                    nfuse = int(val)
                else:  # budget_alpha: fuse ⌊α⌋ queued batches (α=1 ⇒
                       # per-batch, the drivers' "no widening" semantics)
                    nfuse = int(np.floor(val))
            nfuse = max(1, min(nfuse, self.max_fuse, len(batches) - i))
            group = batches[i:i + nfuse]
            sizes = [len(b) for b in group]
            flat = [pair for batch in group for pair in batch]

            t0 = time.perf_counter()
            with current_tracer().span(
                    "serve.engine_dispatch", n_batches=nfuse,
                    n_queries=len(flat), n_rules=n_rules,
                    impl=self.impl) as dspan:
                if flat:
                    kf = (min(k * self.overfetch, n_rules)
                          if self.dedup_consequents else k)
                    vals, idx = self._dispatch(state, state.pack(flat), kf)
                    decoded = self._decode(state, vals, idx, k)
                else:
                    decoded = []
            elapsed = time.perf_counter() - t0
            dspan.set(elapsed_seconds=elapsed)

            off = 0
            for sz in sizes:
                results.append(decoded[off:off + sz])
                off += sz
            n_q = len(flat)
            if self.controller is not None and n_q:
                self.controller.observe_serve(
                    float(n_rules) * state.W + 8.0 * kf * XFER_OPS_PER_BYTE,
                    n_q, elapsed)
            history.append(PhaseStats(n_rules * max(n_q, 1),
                                      max(n_q, 1), elapsed))
            records.append(RuleServeRecord(phase_idx, nfuse, n_q, elapsed))
            i += nfuse
            phase_idx += 1
        self.records = records
        return results, records

    def query(self, baskets, top_k: int | None = None,
              tenant: str | None = None):
        """Single-batch convenience: recommendations for one list of baskets
        (bare baskets or ``(tenant, basket)`` pairs)."""
        results, _ = self.serve([list(baskets)], top_k=top_k, tenant=tenant)
        return results[0]
