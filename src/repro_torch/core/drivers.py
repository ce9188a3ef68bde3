"""Algorithm drivers: SPC, FPC, DPC, VFPC, ETDPC, Optimized-VFPC, Optimized-ETDPC.

``mine()`` is the public entry point.  It runs Job1 (1-itemset counting) and
then the policy-controlled phase loop, mirroring the paper's driver classes.
Per-phase checkpointing makes every driver restartable from the last completed
phase (phases are idempotent — counting is deterministic — the same property
Hadoop's task re-execution relies on).

Every counting job is fused (device-side min-support filter, packed mask
home transfer) and dispatched asynchronously, and the host speculatively
joins the next level while a job is in flight — the device-resident phase
pipeline of DESIGN.md §4.

On a mesh of cells (DESIGN.md §11) ``mine()`` balances shard widths,
re-prices the ``(data, cand)`` split between levels and retries a lost
shard; on one cell all three are no-ops.  On a mesh of several processes
every process runs this same loop, one collective per counting job, and the
decisions priced from a process's own timings (phase widths, the split,
shard balance, stragglers, retries) are agreed across processes first
(``MapReduceRuntime.agree`` / ``any_process``), so every process dispatches
the same jobs.  ``device="cuda"`` is the default and raises without a card;
``device="cpu"`` runs the kernels' plain versions.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np

from repro_torch.costmodel import CostController, device_key
from repro_torch.obs.metrics import get_registry
from repro_torch.obs.trace import current_tracer

from .bitset import pack_itemsets, singleton_masks, unpack_itemsets
from .mapreduce import MapReduceRuntime
from .phases import PhaseResult, bucket_pad, run_phase, wait_count
from .policy import ALGORITHMS, MeasuredPolicy, PhaseStats

# speculate on the next phase's join only when the current level kept at least
# this fraction of its candidates — the wasted-work factor of joining the
# un-filtered level is (|C|/|L|)², so a low survival rate makes the gamble bad
SPEC_SURVIVAL_THRESHOLD = 0.5


@dataclasses.dataclass
class MiningResult:
    algorithm: str
    min_sup: float
    n_txns: int
    n_items: int
    levels: dict                    # k -> (masks (n,W) uint32, counts (n,) int64)
    phases: list                    # list[PhaseResult]
    total_seconds: float
    dispatches: int
    compiles: int
    straggler_events: int = 0
    retries: int = 0                # failed counting jobs recovered by retry
    repartitions: int = 0           # elastic mesh re-layouts this run (§11)
    overlap_seconds: float = 0.0    # host gen time overlapped with counting jobs
    decisions: list = dataclasses.field(default_factory=list)
    # cost-controller telemetry rows for this run (DESIGN.md §9)

    def itemsets(self) -> dict:
        """Friendly view: k -> {sorted item tuple: count}."""
        out = {}
        for k, (masks, counts) in sorted(self.levels.items()):
            if masks.shape[0] == 0:
                continue
            out[k] = dict(zip(unpack_itemsets(masks), (int(c) for c in counts)))
        return out

    @property
    def n_phases(self) -> int:
        return len(self.phases)


def _ckpt_path(d: str) -> str:
    return os.path.join(d, "mining_state.npz")


def _save_ckpt(d: str, algorithm: str, min_sup: float, levels: dict,
               history: list, k_prev: int):
    os.makedirs(d, exist_ok=True)
    payload = {
        "meta": np.frombuffer(json.dumps({
            "algorithm": algorithm, "min_sup": min_sup, "k_prev": k_prev,
            "history": history,
        }).encode(), dtype=np.uint8),
    }
    for k, (masks, counts) in levels.items():
        payload[f"masks_{k}"] = masks
        payload[f"counts_{k}"] = counts
    tmp = os.path.join(d, "mining_state.tmp.npz")
    np.savez(tmp, **payload)
    os.replace(tmp, _ckpt_path(d))


def _load_ckpt(d: str):
    path = _ckpt_path(d)
    if not os.path.exists(path):
        return None
    z = np.load(path)
    meta = json.loads(bytes(z["meta"]).decode())
    levels = {}
    for name in z.files:
        if name.startswith("masks_"):
            k = int(name.split("_")[1])
            levels[k] = (z[name], z[f"counts_{k}"])
    return meta, levels


def mine(transactions=None, *, db_masks: np.ndarray | None = None,
         n_items: int, min_sup: float, algorithm: str = "optimized_vfpc",
         runtime: MapReduceRuntime | None = None, policy_kwargs: dict | None = None,
         checkpoint_dir: str | None = None, resume: bool = True,
         spec_factor: float = 4.0, max_k: int = 64,
         balance_shards_by_width: bool | None = None,
         max_retries: int = 2,
         elastic: bool = True,
         controller=None,
         count_hook=None,
         device="cuda") -> MiningResult:
    """Mine frequent itemsets with the selected pass-combining algorithm.

    Args:
      transactions: iterable of item-id iterables (alternative: db_masks).
      db_masks: pre-packed (N, W) uint32 transaction bitmasks.
      n_items: item catalog size.
      min_sup: fractional minimum support (0, 1].
      algorithm: one of policy.ALGORITHMS keys.
      runtime: MapReduceRuntime (default: one on ``device``, auto impl).
      checkpoint_dir: if set, per-phase checkpoints are written and ``resume``
        restarts from the last completed phase.
      spec_factor: straggler threshold — a counting job slower than
        spec_factor × the median job time is re-dispatched once (speculative
        re-execution analogue; idempotent by determinism).
      balance_shards_by_width: statically LPT-balance per-shard total
        transaction width before scattering (the paper's InputSplit-sizing
        concern).  Default None = measured policy: the controller enables
        it only when the predicted straggler waste of the skewed contiguous
        split exceeds the calibrated re-pack cost (DESIGN.md §11).
      max_retries: per-phase fault tolerance — a counting job that raises
        (a lost shard; injected via ``count_hook`` in tests) is re-dispatched
        up to this many times after re-placing the shards from the retained
        host copy.  Phases are idempotent, so the retried result is exact.
      elastic: per-level mesh repartitioning (DESIGN.md §11) — between
        levels the controller prices the next phase's (C, T) extents under
        every (data, cand) factorization of the cells and re-layouts when
        a different split beats the current one by more than the measured
        re-scatter cost.  No-op on one cell or an uncalibrated model.
      controller: a :class:`repro_torch.costmodel.CostController`.  Every
        run calibrates it from observed job timings (feeding the shared cost
        model); the ``measured`` policy also *decides* from it, and its
        predictions gate speculative-join overlap.  Default: a controller on
        the process-wide shared model, keyed by the runtime's device
        (DESIGN.md §9).
      count_hook: test hook — called as ``("phase_start", k)`` before each
        phase and ``("count_dispatch", k)`` after each counting job is
        dispatched; raising from the latter simulates a shard failure and
        exercises the retry protocol.
      device: "cuda" (default; raises without a card) or "cpu"; used when
        ``runtime`` is not given.

    Returns: MiningResult.
    """
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}; options: {sorted(ALGORITHMS)}")
    policy_cls, optimized = ALGORITHMS[algorithm]
    policy = policy_cls(**(policy_kwargs or {}))
    runtime = runtime or MapReduceRuntime(device=device)
    if controller is None:
        if isinstance(policy, MeasuredPolicy):
            controller = policy.controller
        else:
            controller = CostController()
        # fits describe the device that runs the jobs
        controller.device = device_key(runtime.device)
    elif isinstance(policy, MeasuredPolicy):
        policy.controller = controller    # one controller decides AND observes

    if db_masks is None:
        db_masks = pack_itemsets([list(t) for t in transactions], n_items)
    db_masks = np.asarray(db_masks, dtype=np.uint32)
    n_txns = db_masks.shape[0]
    n_words = db_masks.shape[1]
    min_count = min_sup * n_txns
    # calibration context: within this run, job cost varies only with the
    # candidate count — T, W and the mesh split are pinned here (DESIGN.md §9)
    controller.set_count_context(n_txns=n_txns, n_words=n_words,
                                 impl=runtime.impl,
                                 n_data_shards=runtime.n_data_shards,
                                 n_cand_shards=runtime.n_cand_shards,
                                 cells_per_device=runtime.cells_per_device)
    if balance_shards_by_width is None and runtime.n_data_shards > 1:
        # measured policy (DESIGN.md §11): pay the host re-pack only when
        # the predicted straggler waste of the skewed split exceeds it
        from repro_torch.data.loader import shard_width_loads
        balance_shards_by_width = runtime.agree(controller.should_rebalance(
            shard_width_loads(db_masks, runtime.n_data_shards),
            est_candidates=max(4 * n_items, 256)))
    if balance_shards_by_width and runtime.n_data_shards > 1:
        # static straggler mitigation: LPT-balance per-shard total width
        # under the contiguous split (the paper's InputSplit concern, §5.2)
        from repro_torch.data.loader import balance_masks
        t_bal = time.perf_counter()
        with current_tracer().span("mine.rebalance", n_txns=n_txns,
                                   n_shards=runtime.n_data_shards):
            db_masks = balance_masks(db_masks, runtime.n_data_shards)
        controller.observe_rebalance(n_txns, time.perf_counter() - t_bal)

    tracer = current_tracer()
    t_start = time.perf_counter()
    run_span = tracer.span("mine.run", algorithm=algorithm, n_txns=n_txns,
                           n_items=n_items, min_sup=min_sup)
    overlap_start = runtime.stats.overlap_seconds
    repartitions_start = runtime.stats.repartitions
    with tracer.span("mine.scatter", n_txns=n_txns, n_words=n_words):
        db_sharded = runtime.scatter_db(db_masks, n_items=n_items)
    # re-pin: an "auto" runtime may have switched impl at scatter time
    controller.set_count_context(n_txns=n_txns, n_words=n_words,
                                 impl=runtime.impl,
                                 n_data_shards=runtime.n_data_shards,
                                 n_cand_shards=runtime.n_cand_shards,
                                 cells_per_device=runtime.cells_per_device)
    decisions_mark = len(controller.decisions)
    retries = 0

    def _with_retry(dispatch):
        # Per-phase fault tolerance (DESIGN.md §11): a counting job that
        # raises (count_hook in tests, a real device fault in production)
        # re-places the shards from the retained host copy and
        # re-dispatches.
        # Phases are idempotent — counting is deterministic, generation is
        # pure — so the retried phase is exact.  A job that failed on any
        # process is retried on all of them, so every process makes the
        # same collectives in the same order.
        nonlocal db_sharded, retries
        attempt = 0
        while True:
            err = None
            try:
                out = dispatch()
            except Exception as e:      # decided below, with the others
                err = e
            if not runtime.any_process(err is not None):
                return out
            if attempt >= max_retries or runtime._db_masks is None:
                if err is not None:
                    raise err
                raise RuntimeError("a counting job failed on another "
                                   "process past max_retries")
            attempt += 1
            retries += 1
            db_sharded = runtime.rescatter()

    levels: dict = {}
    phases: list[PhaseResult] = []
    history: list = []       # [(n_candidates, n_frequent_last, elapsed), ...]
    straggler_events = 0
    count_times: list[float] = []

    # -- resume ---------------------------------------------------------------
    k_prev = None
    if checkpoint_dir and resume:
        loaded = _load_ckpt(checkpoint_dir)
        if loaded is not None:
            meta, levels = loaded
            if meta["algorithm"] == algorithm and meta["min_sup"] == min_sup:
                history = [tuple(h) for h in meta["history"]]
                k_prev = meta["k_prev"]
                # Replay policy-internal state: one decide() per completed
                # post-Job1 phase, with the stats it saw at the time.
                for j in range(1, len(history)):
                    policy.decide(
                        PhaseStats(*history[j - 1]),
                        PhaseStats(*history[j - 2]) if j >= 2 else None)
            else:
                levels, history, k_prev = {}, [], None

    def _stats(i):
        if i < 0 or i >= len(history):
            return None
        return PhaseStats(*history[i])

    # -- Job1: frequent 1-itemsets (OneItemsetMapper/Combiner/Reducer) --------
    if k_prev is None:
        t0 = time.perf_counter()
        bytes0 = runtime.stats.bytes_to_host
        singles = singleton_masks(n_items)
        job1_span = tracer.span("mine.phase", k_start=1, npass=1)

        def _job1():
            padded = bucket_pad(singles)
            t_c = time.perf_counter()
            cspan = tracer.span(
                "mine.count", k_start=1, npass=1, n_candidates=n_items,
                padded=int(padded.shape[0]), impl=runtime.impl)
            try:
                fut = runtime.phase_count_async(
                    db_sharded, padded, min_count=min_count, n_valid=n_items)
                cspan.event("count.dispatch")
                if count_hook is not None:
                    count_hook("count_dispatch", 1)
                return wait_count(fut)
            finally:
                cspan.set(count_seconds=time.perf_counter() - t_c).close()

        keep, counts = _with_retry(_job1)
        levels[1] = (singles[keep], counts[keep])
        el = time.perf_counter() - t0
        job1_span.set(elapsed_seconds=el, n_candidates=n_items,
                      n_frequent=int(keep.sum())).close()
        phases.append(PhaseResult(1, 1, [n_items], 0.0, el, el,
                                  [int(keep.sum())], {1: levels[1]}, True))
        history.append((n_items, int(keep.sum()), el))
        controller.observe_count(
            n_items, el,
            bytes_to_host=runtime.stats.bytes_to_host - bytes0)
        k_prev = 1
        if checkpoint_dir and runtime.mesh.rank == 0:
            _save_ckpt(checkpoint_dir, algorithm, min_sup, levels, history, k_prev)

    # -- phase loop ------------------------------------------------------------
    pending_spec = None       # SpecJoin over the previous phase's last level
    pending_keep = None       # its keep mask (resolves spec to join(L) exactly)
    # |L|/|C| of the newest counted level — Job1 (or the resumed history tail)
    # seeds the speculation guard
    last_survival = (history[-1][1] / history[-1][0]
                     if history and history[-1][0] else 0.0)
    while k_prev in levels and levels[k_prev][0].shape[0] > 0 and k_prev < max_k:
        prev_frequent = levels[k_prev][0]
        ph_span = tracer.span("mine.phase", k_start=k_prev + 1)
        # widths priced from a process's own timings: process 0's decide
        mode, val = runtime.agree(policy.decide(_stats(len(history) - 1),
                                                _stats(len(history) - 2)))
        kwargs = {}
        if mode == "width":
            kwargs["npass"] = int(val)
        else:  # budget_alpha: ct = alpha * |L_prev last level|
            kwargs["budget"] = float(val) * prev_frequent.shape[0]

        # expected candidate extent of the phase about to run — sizes both
        # the speculation gate and the elastic mesh decision
        est_cands = int(prev_frequent.shape[0] * (
            kwargs["npass"] if "npass" in kwargs else max(val, 1.0)))

        # elastic per-level repartitioning (DESIGN.md §11): candidate counts
        # explode between levels, so re-price the (data, cand) split at each
        # phase's extents and re-layout when the win beats the re-scatter
        if elastic and runtime.mesh.size > 1 and runtime.can_repartition:
            split = runtime.agree(controller.choose_mesh(
                est_cands, n_devices=runtime.mesh.size,
                current=runtime.mesh_split))
            if split is not None and tuple(split) != runtime.mesh_split:
                t_rp = time.perf_counter()
                with tracer.span("mine.repartition",
                                 n_data=split[0], n_cand=split[1]):
                    db_sharded = runtime.repartition(*split)
                controller.observe_repartition(
                    n_txns, n_words, time.perf_counter() - t_rp)
                controller.set_count_context(
                    n_txns=n_txns, n_words=n_words, impl=runtime.impl,
                    n_data_shards=split[0], n_cand_shards=split[1],
                    cells_per_device=runtime.cells_per_device)

        # size the overlap from predictions: a count job predicted shorter
        # than the join it would hide is not worth speculating over
        do_spec = (last_survival >= SPEC_SURVIVAL_THRESHOLD
                   and controller.should_speculate(est_cands))
        if count_hook is not None:
            count_hook("phase_start", k_prev)
        bytes0 = runtime.stats.bytes_to_host
        res = _with_retry(lambda: run_phase(
            runtime, db_sharded, n_txns, prev_frequent, k_prev,
            min_count, optimized=optimized, speculate=do_spec,
            spec=pending_spec, prev_keep=pending_keep,
            count_hook=count_hook, **kwargs))
        # Straggler mitigation: re-dispatch a pathologically slow counting job.
        if count_times and runtime.any_process(
                res.count_seconds > spec_factor * float(np.median(count_times))):
            straggler_events += 1
            ph_span.event("straggler.redispatch",
                          count_seconds=res.count_seconds)
            t_re = time.perf_counter()
            # no speculation on the re-dispatch: the first run already did (and
            # counted) it, and a second join would double-book overlap_seconds
            res2 = _with_retry(lambda: run_phase(
                runtime, db_sharded, n_txns, prev_frequent, k_prev,
                min_count, optimized=optimized, speculate=False,
                spec=pending_spec, prev_keep=pending_keep, **kwargs))
            res2.spec, res2.last_keep = res.spec, res.last_keep
            if time.perf_counter() - t_re < res.elapsed_seconds:
                res = res2
        count_times.append(res.count_seconds)

        if res.npass == 0:     # no candidates could be generated → done
            ph_span.set(npass=0).close()
            break
        # calibrate on the phase's full cost (minus the speculative join that
        # belongs to the next phase) — the intercept must capture generation
        # and host-sync overhead too, or fusion looks worthless to the model
        controller.observe_count(
            sum(res.candidate_counts),
            max(res.elapsed_seconds - res.spec_seconds, 0.0),
            bytes_to_host=runtime.stats.bytes_to_host - bytes0)
        controller.observe_spec(res.spec_seconds)
        phases.append(res)
        levels.update(res.levels)
        # policies see the phase's own cost: speculative-join time belongs to
        # the *next* phase's generation (which it replaces), so exclude it —
        # otherwise time-threshold policies (DPC/ETDPC) feed back on it
        history.append((sum(res.candidate_counts),
                        res.frequent_counts[-1] if res.frequent_counts else 0,
                        max(res.elapsed_seconds - res.spec_seconds, 0.0)))
        k_prev = res.k_start + res.npass - 1
        pending_spec, pending_keep = res.spec, res.last_keep
        # the spec arrays are only needed until the next phase resolves them;
        # don't let MiningResult.phases pin every phase's join output forever
        res.spec = res.last_keep = None
        last_survival = (res.frequent_counts[-1] / res.candidate_counts[-1]
                         if res.candidate_counts and res.candidate_counts[-1]
                         else 0.0)
        if checkpoint_dir and runtime.mesh.rank == 0:
            _save_ckpt(checkpoint_dir, algorithm, min_sup, levels, history, k_prev)
        ph_span.set(npass=res.npass,
                    n_candidates=sum(res.candidate_counts),
                    n_frequent=res.frequent_counts[-1],
                    elapsed_seconds=res.elapsed_seconds,
                    overlap_seconds=res.overlap_seconds).close()

    # drop trailing empty levels
    levels = {k: v for k, v in levels.items() if v[0].shape[0] > 0}
    total_seconds = time.perf_counter() - t_start
    run_span.set(total_seconds=total_seconds, phases=len(phases),
                 dispatches=runtime.stats.dispatches,
                 impl=runtime.impl).close()
    get_registry().gauge("mine.total_seconds").set(total_seconds)
    return MiningResult(
        algorithm=algorithm, min_sup=min_sup, n_txns=n_txns, n_items=n_items,
        levels=levels, phases=phases,
        total_seconds=total_seconds,
        dispatches=runtime.stats.dispatches, compiles=runtime.stats.compiles,
        straggler_events=straggler_events,
        retries=retries,
        repartitions=runtime.stats.repartitions - repartitions_start,
        overlap_seconds=runtime.stats.overlap_seconds - overlap_start,
        decisions=controller.decision_rows(decisions_mark))
