"""StreamMiner: continuous exact mining over a transaction window
(DESIGN.md §8) — the port of the JAX package's ``stream/miner.py``.

Every window mutation takes one of two paths:

* **delta** — one O(delta) signed counting dispatch updates all tracked
  candidate counts (``kernels/delta_count.py``: the ``delta_count`` or
  ``delta_count_matmul`` kernel on a card), and the host cascade
  (:func:`~repro_torch.stream.tables.derive_frequent`) re-derives the frequent
  levels exactly from the running tables;
* **re-mine** — the always-available fallback: a full policy-driven
  ``mine()`` over the window contents (reusing ``core/phases.py`` /
  ``core/policy.py`` pass combining) plus one extra MapReduce job counting
  the negative border, which re-tightens the tracked tables.

Re-mining triggers ETDPC-style: *mandatorily* when the cascade reports
structural drift (a needed candidate is untracked — its count is unknown),
and *opportunistically* when ``drift × staleness`` exceeds the *predicted*
cost of re-mining the current window — ``drift`` being the fraction of the
window churned since the last re-mine and ``staleness`` the delta-counting
seconds accumulated since then.  The prediction comes from the shared
:class:`~repro_torch.costmodel.CostController` (DESIGN.md §9), calibrated
from every completed re-mine, so it scales with the window.

Either way the published state is exact: frequent itemsets, supports and the
generated :class:`~repro_torch.core.rules.RuleSet` are byte-identical to a
from-scratch mine of the current window at every step (tested in
``tests/test_torch_stream.py``).  When the published levels change, a fresh
RuleSet is atomically swapped into the live
:class:`~repro_torch.serving.rules_engine.RuleServeEngine`
(:meth:`~repro_torch.serving.rules_engine.RuleServeEngine.swap_rules`), so
recommendation queries always run against complete, current rules.

Every stage runs on the miner's ``device``: the window ring, the re-mine's
counting jobs, the delta kernels, the rule metric pass and serving.
"""

from __future__ import annotations

import dataclasses
import time

from repro_torch.core.drivers import MiningResult, mine
from repro_torch.core.mapreduce import MapReduceRuntime, resolve_device
from repro_torch.core.phases import bucket_pad
from repro_torch.core.policy import ALGORITHMS
from repro_torch.core.rules import generate_ruleset
from repro_torch.kernels.delta_count import DELTA_IMPLS, delta_count
from repro_torch.obs.trace import current_tracer
from repro_torch.serving.rules_engine import RuleServeEngine

from .tables import (TrackedTables, build_tracked_levels, derive_frequent,
                     levels_equal)
from .window import TransactionWindow

STREAM_IMPLS = DELTA_IMPLS


@dataclasses.dataclass
class StreamUpdate:
    """Per-update trace record (the streaming analogue of PhaseResult)."""
    seq: int
    path: str                 # "delta" | "remine" | "remine_structural" |
                              # "remine_staleness" | "empty"
    n_added: int
    n_evicted: int
    window_size: int
    update_seconds: float     # total wall time of the update
    delta_seconds: float      # signed counting + cascade time (delta path)
    remine_seconds: float     # full re-mine + border job time (re-mine paths)
    refresh_seconds: float    # RuleSet regeneration + atomic engine swap
    n_frequent: int
    n_rules: int
    levels_changed: bool


class StreamMiner:
    """Continuously mine a streaming transaction window, exactly.

    Args:
      n_items: item catalog size.
      min_sup: fractional minimum support over the *current* window size.
      capacity / mode: window sizing (see :class:`TransactionWindow`).
      algorithm: pass-combining driver for full re-mines (core/policy.py).
      min_confidence: rule threshold for the published RuleSet.
      runtime: shared MapReduceRuntime on ``device`` (default: a new one).
      impl: delta-counting family — "jnp" (the popcount kernel) or "matmul"
        (the bit-plane kernel); "auto" is "jnp", the reference's static
        choice off the TPU (autotuning the choice is not ported yet).
      staleness_factor: β-style scale on the re-mine trigger — re-mine when
        ``drift × staleness > staleness_factor × predicted_remine_seconds``.
      controller: a :class:`repro_torch.costmodel.CostController` shared with the
        embedded ``mine()`` calls; predicts re-mine cost at the current
        window size and records per-decision telemetry.  Default: a
        controller on the process-wide shared model.
      policy_kwargs: hyperparameters for the re-mine driver's policy
        (``time_scale``, β's, ... — forwarded to ``mine()``).
      track_margin: fractional support headroom of the tracked tables
        (see ``tables.build_tracked_levels``): larger margins absorb more
        near-threshold churn on the delta path at the cost of tracking (and
        delta-counting) more border candidates.
      refresh_rules: regenerate + atomically swap the RuleSet into
        ``self.engine`` whenever the published levels change.
      warm_queries: warm the swapped-in arena with one dispatch per query
        bucket up to this many queries *before* publishing the swap
        (0 = no pre-warm).
      oracle_check: after every update, run a from-scratch ``mine()`` on the
        window and assert exact equality — the equivalence oracle (slow;
        tests/CI only).
      serve_kwargs: extra RuleServeEngine keyword args.
      device: "cuda" (default; raises without a card) or "cpu" (the
        kernels' plain versions).
    """

    def __init__(self, n_items: int, min_sup: float, *,
                 capacity: int = 1024, mode: str = "sliding",
                 algorithm: str = "optimized_etdpc",
                 min_confidence: float = 0.6,
                 runtime: MapReduceRuntime | None = None,
                 impl: str = "auto", staleness_factor: float = 1.0,
                 track_margin: float = 0.1,
                 refresh_rules: bool = True, warm_queries: int = 0,
                 oracle_check: bool = False,
                 serve_kwargs: dict | None = None,
                 controller=None, policy_kwargs: dict | None = None,
                 device="cuda"):
        if algorithm not in ALGORITHMS:
            raise ValueError(
                f"unknown algorithm {algorithm!r}; options: {sorted(ALGORITHMS)}")
        if impl not in STREAM_IMPLS:
            raise ValueError(
                f"unknown impl {impl!r}; options: {STREAM_IMPLS} — the port "
                f"has two delta-counting families, 'jnp' (popcount kernel) "
                f"and 'matmul' (bit-plane kernel)")
        self.device = resolve_device(device)
        if runtime is not None and runtime.device != self.device:
            raise ValueError(f"the runtime counts on {runtime.device}, the "
                             f"miner runs on {self.device}")
        self.n_items = n_items
        self.min_sup = min_sup
        self.algorithm = algorithm
        self.min_confidence = min_confidence
        self.impl = impl
        self.staleness_factor = staleness_factor
        self.track_margin = track_margin
        self.refresh_rules = refresh_rules
        self.warm_queries = warm_queries
        self.oracle_check = oracle_check
        self.policy_kwargs = policy_kwargs
        self.window = TransactionWindow(n_items, capacity=capacity, mode=mode,
                                        device=self.device)
        self.runtime = runtime or MapReduceRuntime(device=self.device)
        if controller is None:
            from repro_torch.costmodel import CostController
            controller = CostController()
        self.controller = controller
        self._tables: TrackedTables | None = None
        self._published: dict = {}
        self.engine = RuleServeEngine(
            generate_ruleset(self._snapshot({}), min_confidence, self.device),
            device=self.device, **(serve_kwargs or {}))
        self.updates: list[StreamUpdate] = []
        self.n_remines = 0
        self._remine_seconds: float | None = None   # last measured full cost
        self._delta_seconds_accum = 0.0             # since the last re-mine
        self._rows_since_remine = 0

    # -- public surface --------------------------------------------------------

    @property
    def levels(self) -> dict:
        """Published frequent levels ``{k: (masks, counts)}`` — exact for the
        current window."""
        return self._published

    @property
    def n_frequent(self) -> int:
        return int(sum(v[0].shape[0] for v in self._published.values()))

    @property
    def n_tracked(self) -> int:
        """Candidates currently carried by the running count tables."""
        return self._tables.n_tracked if self._tables is not None else 0

    def push(self, transactions=None, *, masks=None) -> StreamUpdate:
        """Append a micro-batch (item-id lists or pre-packed masks) and
        refresh the published state."""
        return self._apply(self.window.append(transactions, masks=masks))

    def evict(self, n: int) -> StreamUpdate:
        """Evict the ``n`` oldest transactions and refresh."""
        return self._apply(self.window.evict(n))

    def result(self) -> MiningResult:
        """MiningResult-shaped snapshot of the published exact state."""
        return self._snapshot(dict(self._published))

    def query(self, baskets, top_k: int | None = None):
        """Recommendations from the live (last-swapped) RuleSet."""
        return self.engine.query(baskets, top_k=top_k)

    # -- update machinery ------------------------------------------------------

    def _snapshot(self, levels: dict) -> MiningResult:
        return MiningResult(
            algorithm=f"stream[{self.algorithm}]", min_sup=self.min_sup,
            n_txns=self.window.size, n_items=self.n_items, levels=levels,
            phases=[], total_seconds=0.0,
            dispatches=self.runtime.stats.dispatches,
            compiles=self.runtime.stats.compiles)

    def _predicted_remine_seconds(self) -> float | None:
        """Re-mine cost predicted for the *current* window size — grows with
        the window even when the only observation is the tiny init-time mine
        (DESIGN.md §9)."""
        predicted = self.controller.predict_remine(self.window.size)
        return predicted if predicted is not None else self._remine_seconds

    def _staleness_triggered(self) -> bool:
        if self.window.size == 0 or self._remine_seconds is None:
            return False
        drift = self._rows_since_remine / self.window.size
        return self.controller.should_remine(
            drift=drift, staleness_seconds=self._delta_seconds_accum,
            window_rows=self.window.size,
            staleness_factor=self.staleness_factor,
            fallback_seconds=self._remine_seconds)

    def _remine(self) -> dict:
        """Full from-scratch mine + per-level border jobs; re-tightens the
        tables around the current window (margin-expanded, see tables.py)."""
        t0 = time.perf_counter()
        remine_span = current_tracer().span("stream.remine",
                                            window=self.window.size)
        contents = self.window.contents()
        res = mine(db_masks=contents, n_items=self.n_items,
                   min_sup=self.min_sup, algorithm=self.algorithm,
                   runtime=self.runtime, controller=self.controller,
                   policy_kwargs=self.policy_kwargs)
        db_sharded = self.runtime.scatter_db(contents, n_items=self.n_items)

        def count_fn(masks):
            return self.runtime.phase_count(
                db_sharded, bucket_pad(masks))[:masks.shape[0]]

        tracked = build_tracked_levels(
            res.levels, self.n_items, self.min_sup * self.window.size,
            self.track_margin, count_fn)
        self._tables = TrackedTables(tracked)
        self._remine_seconds = time.perf_counter() - t0
        remine_span.set(seconds=self._remine_seconds,
                        n_tracked=self._tables.n_tracked).close()
        # calibrate the predictor: one sample per completed re-mine, in the
        # window-rows ops basis (mine + border jobs + table rebuild, end to end)
        self.controller.observe_remine(self.window.size, self._remine_seconds)
        self._delta_seconds_accum = 0.0
        self._rows_since_remine = 0
        self.n_remines += 1
        return dict(res.levels)

    def _apply(self, delta) -> StreamUpdate:
        tracer = current_tracer()
        t0 = time.perf_counter()
        upd_span = tracer.span("stream.update", seq=len(self.updates),
                               n_added=delta.n_added,
                               n_evicted=delta.n_evicted)
        delta_s = remine_s = 0.0
        if self.window.size == 0:
            # empty window: min_count would be 0 and "frequent" degenerate —
            # publish the empty state and force a re-mine on the next fill
            new_levels: dict | None = {}
            self._tables = None
            path = "empty"
        elif self._tables is None:
            new_levels = self._remine()
            remine_s = self._remine_seconds
            path = "remine"
        else:
            td = time.perf_counter()
            with tracer.span("stream.delta_count",
                             n_tracked=self._tables.n_tracked,
                             impl=self.impl):
                deltas = delta_count(self._tables.cat_padded, delta.added,
                                     delta.evicted, impl=self.impl,
                                     device=self.device)
                self._tables.apply_delta(deltas[:self._tables.n_tracked])
                derived = derive_frequent(self._tables,
                                          self.min_sup * self.window.size)
            delta_s = time.perf_counter() - td
            self._delta_seconds_accum += delta_s
            self._rows_since_remine += delta.n_added + delta.n_evicted
            if derived is None:
                new_levels = self._remine()
                remine_s = self._remine_seconds
                path = "remine_structural"
            elif self._staleness_triggered():
                new_levels = self._remine()
                remine_s = self._remine_seconds
                path = "remine_staleness"
            else:
                new_levels = derived
                path = "delta"

        if self.oracle_check and self.window.size > 0:
            oracle = mine(db_masks=self.window.contents(),
                          n_items=self.n_items, min_sup=self.min_sup,
                          algorithm=self.algorithm, runtime=self.runtime)
            assert levels_equal(new_levels, oracle.levels), \
                f"incremental state diverged from scratch mine ({path})"

        changed = not levels_equal(new_levels, self._published)
        self._published = new_levels
        refresh_s = 0.0
        if changed and self.refresh_rules:
            tr = time.perf_counter()
            with tracer.span("stream.refresh_rules"):
                ruleset = generate_ruleset(self.result(), self.min_confidence,
                                           self.device)
                self.engine.swap_rules(ruleset,
                                       warm_to=self.warm_queries or None)
            refresh_s = time.perf_counter() - tr

        upd_span.set(path=path, window=self.window.size,
                     n_frequent=self.n_frequent,
                     levels_changed=changed).close()
        rec = StreamUpdate(
            seq=len(self.updates), path=path,
            n_added=delta.n_added, n_evicted=delta.n_evicted,
            window_size=self.window.size,
            update_seconds=time.perf_counter() - t0,
            delta_seconds=delta_s, remine_seconds=remine_s,
            refresh_seconds=refresh_s, n_frequent=self.n_frequent,
            n_rules=self.engine.n_rules, levels_changed=changed)
        self.updates.append(rec)
        return rec
