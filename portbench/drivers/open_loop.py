"""Tenants' queries arriving on their own schedule, answered in real time.

Set-up mines each tenant's slice of the configuration's rows, generates its
rules, packs all tenants into one arena (``RuleStore``), builds the
``RuleServeEngine`` and its ``OpenLoopServer`` as the rule-serving CLI does,
warms the engine at the dispatch shapes the server uses, and then runs
``warmup_s`` of the same traffic through a server of its own, so admission's
cost model is calibrated before the window.

The window offers ``rate_qps × seconds`` queries at times drawn from the
seed (a Poisson process given its count: uniform times, sorted), tenants
uniform, each basket a row of its tenant's slice with one item dropped.
Each query is handed to the server when it is due, or as soon after as the
caller is free (the server answers inside ``submit``); it is answered when
the call that served it returns, and its latency runs from its due time to
then, on this clock.  Shed queries count as failed.  Every answered query's
recommendations, and every tenant's rule set, are held against the
reference's.
"""

from __future__ import annotations

import time

import numpy as np

from portbench.data.generators import drop_one_queries, generate, pack
from portbench.harness.result import Outcome
from portbench.harness.window import Record, Window
from portbench.reference import apriori as ref_apriori
from portbench.reference import rules as ref_rules

from . import mining


def schedule(rng: np.random.Generator, rate: float, seconds: float,
             slices: dict) -> tuple:
    """``(due offsets (n,), tenants (n,), baskets)`` for ``rate × seconds``
    queries."""
    n = int(round(rate * seconds))
    due = np.sort(rng.random(n)) * seconds
    names = list(slices)
    ten = rng.integers(0, len(names), n)
    baskets = [None] * n
    for t, name in enumerate(names):
        idx = np.nonzero(ten == t)[0]
        for i, b in zip(idx, drop_one_queries(rng, slices[name], idx.size)):
            baskets[i] = b
    return due, [names[t] for t in ten], baskets


def wait_until(t: float, clock=time.perf_counter, sleep=time.sleep) -> None:
    """Return at ``t``: sleep while more than a millisecond is left, then
    spin."""
    while True:
        left = t - clock()
        if left <= 0:
            return
        if left > 1e-3:
            sleep(left - 5e-4)


def offer(server, due: np.ndarray, tenants: list, baskets: list,
          clock=time.perf_counter, sleep=time.sleep) -> dict:
    """Hand each query to ``server`` at its due time (offsets from now), in
    order, and time its answer.  Returns the window's ``t0`` and ``t1``,
    each query's ``late`` (seconds past due when handed over), ``done``
    (when answered; NaN if shed) and its outcome."""
    n = due.size
    late = np.zeros(n)
    done = np.full(n, np.nan)
    outcomes = [None] * n
    pending = []
    t0 = clock() + 1e-3

    def settle(t_ret):
        keep = []
        for j in pending:
            o = outcomes[j]
            if o.outcome == "queued":
                keep.append(j)
            elif o.outcome in ("served", "cached"):
                done[j] = t_ret
        pending[:] = keep

    for i in range(n):
        wait_until(t0 + due[i], clock, sleep)
        now = clock()
        late[i] = now - (t0 + due[i])
        outcomes[i] = server.submit(baskets[i], now - t0, tenant=tenants[i])
        pending.append(i)
        settle(clock())
    server.flush(clock() - t0)
    t1 = clock()
    settle(t1)
    return {"t0": t0, "t1": t1, "late": late, "done": done,
            "outcomes": outcomes}


class Service:
    """The served deployment, set up once: each tenant's mined rules in one
    arena, the engine warmed at the server's dispatch shapes, and a factory
    of fresh ``OpenLoopServer``s sharing the engine's cost model."""

    def __init__(self, config: dict, device):
        from repro_torch.core.mapreduce import MapReduceRuntime
        from repro_torch.core.rules import generate_ruleset
        from repro_torch.costmodel import CostController
        from repro_torch.serving import RuleServeEngine, RuleStore

        self.config, self.device = config, device
        sv = self.sv = config["serve"]
        rows = generate(config["dataset"])
        self.slices = {f"t{i}": rows[i::sv["tenants"]]
                       for i in range(sv["tenants"])}
        rules = {}
        for name, sl in self.slices.items():
            rt = MapReduceRuntime(device=device, impl=config["mine"]["impl"])
            res = mining.mine_once(pack(sl), config, rt)
            rules[name] = generate_ruleset(res, min_confidence=sv["min_conf"],
                                           device=device)
        self.store = RuleStore(tenants=rules, device=device)
        self.controller = CostController()
        self.engine = RuleServeEngine(
            self.store, top_k=sv["top_k"], impl=sv["rule_impl"],
            algorithm=sv["fusion"], max_fuse=sv["max_fuse"],
            controller=self.controller, device=device)
        self.engine.warmup(sv["batch"])

    def server(self):
        from repro_torch.serving import OpenLoopServer
        sv = self.sv
        return OpenLoopServer(
            self.engine, latency_slo_ms=sv["latency_slo_ms"],
            batch=sv["batch"], max_wait_ms=sv["max_wait_ms"],
            cache_size=sv["cache_size"], fair_shedding=sv["fair_shedding"],
            controller=self.controller)

    @property
    def fetch(self) -> int:
        """Ranked rules an answer is drawn from (the engine's overfetch)."""
        return min(self.sv["top_k"] * self.engine.overfetch,
                   len(self.store.state))


def run(ctx) -> Outcome:
    import torch

    config, traffic, dev = ctx.config, ctx.traffic, ctx.device
    svc = Service(config, dev)
    rng = np.random.default_rng(ctx.seed)
    warm_rng, rng = rng.spawn(2)
    rate = float(traffic["rate_qps"])
    offer(svc.server(), *schedule(warm_rng, rate, traffic["warmup_s"],
                                  svc.slices))
    due, tenants, baskets = schedule(rng, rate, ctx.seconds, svc.slices)

    srv = svc.server()
    win = Window(dev, ctx.trace)
    win.open()
    got = offer(srv, due, tenants, baskets)
    win.close()
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(dev).type == "cuda" else 0)
    t0 = got["t0"]
    answered = np.nonzero(~np.isnan(got["done"]))[0]
    if answered.size == 0:
        raise RuntimeError(f"no query of {len(baskets)} was answered")
    latency = got["done"][answered] - (t0 + due[answered])
    shed = sum(1 for o in got["outcomes"] if o.outcome == "shed")
    state = svc.store.state
    fetch = svc.fetch

    record = None
    if ctx.trace:
        spans = win.spans()
        work = [("rules", int(a["n_queries"]), len(state), state.n_items,
                 fetch) for name, _, _, a in spans if name == "serve.dispatch"]
        record = Record(
            spans=spans,
            counters={"queries": len(baskets), "answered": int(answered.size),
                      "shed": shed, "cached": sum(
                          1 for o in got["outcomes"] if o.outcome == "cached"),
                      "late_s": got["late"], "latency_s": latency},
            chips=[win.chip()], window_s=win.seconds, work=work)

    port_rules = {t: rule_arrays(state.rulesets[t]) for t in svc.slices}
    port_answers = [[(r.consequent, r.score)
                     for r in got["outcomes"][i].results] for i in answered]
    slices = svc.slices
    del srv, svc, state, got
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    want_rules = reference_rules(config, slices)
    rules_wrong = sum(ruleset_mismatches(port_rules[t], want_rules[t])
                      for t in slices)
    want = reference_answers(config, want_rules, fetch,
                             [tenants[i] for i in answered],
                             [baskets[i] for i in answered], dev)
    answers_wrong = sum(1 for g, w in zip(port_answers, want) if g != w)

    n_rules = sum(r["ante"].shape[0] for r in want_rules.values())
    return Outcome(
        metrics={"recommend_p95_ms": float(np.percentile(latency, 95)) * 1e3,
                 "recommend_p50_ms": float(np.percentile(latency, 50)) * 1e3},
        t_window=t0, checks={"rules_wrong": (rules_wrong, 0),
                             "answers_wrong": (answers_wrong, 0)},
        attempted=len(baskets), failed=len(baskets) - int(answered.size),
        memory_peak=peak, record=record,
        notes=[f"offered {len(baskets)} queries at {rate} qps over "
               f"{ctx.seconds} s: {answered.size} answered, {shed} shed; "
               f"{answered.size} answers and {n_rules} rules held against "
               f"the reference"])


def reference_rules(config: dict, slices: dict, score_dtype=None) -> dict:
    """Each tenant's rule set, worked out by the reference."""
    kw = {} if score_dtype is None else {"score_dtype": score_dtype}
    return {name: ref_rules.rules(
                ref_apriori.apriori(sl, config["mine"]["min_sup"]),
                sl.shape[0], mining.n_items(config),
                config["serve"]["min_conf"], **kw)
            for name, sl in slices.items()}


def reference_answers(config: dict, rules: dict, fetch: int, tenants: list,
                      baskets: list, device) -> list:
    """The reference's answer to each ``(tenant, basket)``, in order."""
    out = [None] * len(baskets)
    for name, rs in rules.items():
        idx = [i for i, t in enumerate(tenants) if t == name]
        for i, a in zip(idx, ref_rules.recommend(
                rs, [baskets[i] for i in idx], mining.n_items(config),
                config["serve"]["top_k"], fetch, device=device)):
            out[i] = a
    return out


def rule_arrays(ruleset) -> dict:
    """The port's RuleSet in the reference's layout."""
    return {"ante": ruleset.ante_masks, "cons": ruleset.cons_masks,
            "union": ruleset.union_counts, "ante_n": ruleset.ante_counts,
            "cons_n": ruleset.cons_counts, "score": ruleset.score}


def ruleset_mismatches(got: dict, want: dict) -> int:
    """Rules at positions where two rule sets differ (masks, counts or
    float32 score bits), and rules only one of them has."""
    n_g, n_w = got["ante"].shape[0], want["ante"].shape[0]
    n = min(n_g, n_w)
    same = np.ones(n, bool)
    for key in ("ante", "cons"):
        same &= (got[key][:n] == want[key][:n]).all(axis=1)
    for key in ("union", "ante_n", "cons_n"):
        same &= got[key][:n] == want[key][:n]
    same &= (np.asarray(got["score"][:n], np.float32).view(np.uint32)
             == want["score"][:n].view(np.uint32))
    return int(n - same.sum()) + abs(n_g - n_w)
