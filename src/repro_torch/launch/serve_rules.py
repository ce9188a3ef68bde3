"""CLI: mine → rules → serve association-rule recommendation queries, on
the port.

  PYTHONPATH=src python -m repro_torch.launch.serve_rules --dataset mushroom \
      --scale 0.08 --min-sup 0.35 --min-conf 0.7 --queries 256 --batch 32 \
      [--device cpu]

Mines the dataset, generates the RuleSet (DESIGN.md §7), then replays a
synthetic query stream (sampled transactions with one item dropped) through
the RuleServeEngine with policy-fused micro-batching, reporting rules/s,
queries/s and per-dispatch latency percentiles.

Multi-tenant / SLO serving (DESIGN.md §12): ``--tenants N`` round-robin
splits the transaction stream, mines one RuleSet per tenant and serves the
mixed-tenant query stream through one packed arena; ``--rate-qps`` switches
to an open-loop arrival clock with ``--latency-slo-ms`` admission and an LRU
result cache, reporting sustained qps, p99 and shed rate.  ``--json-out``
records per-query shed/cache/fused outcomes plus the controller's decision
telemetry.  ``--device cuda`` (the default) needs a card and raises without
one; every stage — mining, rule generation and serving — runs on ``--device``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.core import generate_ruleset, mine
from repro_torch.core.mapreduce import MapReduceRuntime
from repro_torch.core.policy import ALGORITHMS
from repro_torch.costmodel import CostController
from repro_torch.data import dataset_by_name, load_transactions
from repro_torch.launch.cliopts import (add_obs_args, add_policy_args,
                                        add_serving_args,
                                        policy_kwargs_from_args,
                                        tracer_from_args, write_obs_outputs)
from repro_torch.serving import (RULE_IMPLS, OpenLoopServer, RuleServeEngine,
                                 RuleStore)
from repro_torch.serving.common import latency_ms


def make_queries(txns, n_queries: int, seed: int = 0):
    """Sample transactions and drop one random item each — baskets with a
    natural 'missing' consequent for the rules to fill in."""
    rng = np.random.default_rng(seed)
    picks = rng.integers(0, len(txns), n_queries)
    out = []
    for p in picks:
        t = list(txns[p])
        if len(t) > 1:
            t.pop(rng.integers(0, len(t)))
        out.append(t)
    return out


def mine_tenants(txns, n_items: int, n_tenants: int, args):
    """Round-robin split the stream and mine one RuleSet per tenant slice —
    N genuinely different catalogs from one dataset, no extra data."""
    tenants: dict = {}
    slices: dict = {}
    for i in range(n_tenants):
        name = f"t{i}"
        slice_ = txns[i::n_tenants]
        res = mine(slice_, n_items=n_items, min_sup=args.min_sup,
                   algorithm=args.mine_algorithm,
                   runtime=MapReduceRuntime(device=args.device))
        tenants[name] = generate_ruleset(res, min_confidence=args.min_conf,
                                         device=args.device)
        slices[name] = slice_
    return tenants, slices


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="mushroom",
                    help="named synthetic dataset (c20d10k/chess/mushroom/...)")
    ap.add_argument("--input", default=None, help="FIMI-format transaction file")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--min-sup", type=float, default=0.35)
    ap.add_argument("--min-conf", type=float, default=0.7)
    ap.add_argument("--mine-algorithm", default="optimized_vfpc",
                    choices=sorted(ALGORITHMS))
    ap.add_argument("--algorithm", default="optimized_vfpc",
                    choices=sorted(ALGORITHMS),
                    help="query micro-batch fusion policy (spc = per-batch)")
    ap.add_argument("--impl", default="auto", choices=RULE_IMPLS,
                    help="containment-scoring impl (default auto)")
    ap.add_argument("--top-k", type=int, default=5)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--max-fuse", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (hand-written kernels) or cpu "
                         "(their plain versions)")
    ap.add_argument("--json-out", default=None)
    add_policy_args(ap)
    add_serving_args(ap)
    add_obs_args(ap)
    args = ap.parse_args(argv)
    tracer = tracer_from_args(args)

    if args.input:
        txns, n_items = load_transactions(args.input)
    else:
        txns, n_items = dataset_by_name(args.dataset, seed=args.seed,
                                        scale=args.scale)

    controller = CostController()
    record: dict = {}
    t0 = time.perf_counter()
    if args.tenants > 1:
        tenants, slices = mine_tenants(txns, n_items, args.tenants, args)
        gen_s = time.perf_counter() - t0
        n_rules = sum(len(r) for r in tenants.values())
        per = ", ".join(f"{t}:{len(r)}" for t, r in tenants.items())
        print(f"mined {args.tenants} tenant slices in {gen_s:.2f}s — "
              f"{n_rules} rules ({per}, min_conf={args.min_conf})")
        if n_rules == 0:
            print("no rules above min_conf; lower --min-conf or --min-sup")
            return
        store = RuleStore(tenants=tenants, device=args.device)
        names = list(tenants)
        queries = []
        for i in range(args.queries):
            name = names[i % len(names)]
            q = make_queries(slices[name], 1, seed=args.seed + 1 + i)[0]
            queries.append((name, q))
        record["tenants"] = {t: len(r) for t, r in tenants.items()}
    else:
        res = mine(txns, n_items=n_items, min_sup=args.min_sup,
                   algorithm=args.mine_algorithm,
                   runtime=MapReduceRuntime(device=args.device))
        t1 = time.perf_counter()
        rules = generate_ruleset(res, min_confidence=args.min_conf,
                                 device=args.device)
        gen_s = time.perf_counter() - t1
        print(f"mined {sum(v[0].shape[0] for v in res.levels.values())} "
              f"frequent itemsets in {res.n_phases} phases "
              f"({res.total_seconds:.2f}s, {res.dispatches} jobs)")
        print(f"rules: {len(rules)} (min_conf={args.min_conf}) in "
              f"{gen_s*1e3:.1f} ms = "
              f"{len(rules)/max(gen_s, 1e-9):,.0f} rules/s")
        if len(rules) == 0:
            print("no rules above min_conf; lower --min-conf or --min-sup")
            return
        store = RuleStore(rules, device=args.device)
        queries = make_queries(txns, args.queries, seed=args.seed + 1)
        record["rules_per_s"] = len(rules) / max(gen_s, 1e-9)
        n_rules = len(rules)
    record["n_rules"] = n_rules

    eng = RuleServeEngine(store, top_k=args.top_k, impl=args.impl,
                          algorithm=args.algorithm, max_fuse=args.max_fuse,
                          policy_kwargs=policy_kwargs_from_args(
                              args, args.algorithm),
                          latency_budget_ms=args.latency_budget_ms,
                          controller=controller, device=args.device)
    eng.warmup(args.batch * args.max_fuse)      # build + first launches

    if args.rate_qps:
        serve_open_loop(eng, queries, args, controller, record)
    else:
        serve_closed_loop(eng, queries, args, record)
    record["decisions"] = controller.decision_rows()

    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(record, f, indent=2)
    write_obs_outputs(args, tracer)


def serve_closed_loop(eng, queries, args, record: dict) -> None:
    """Back-to-back batch replay: the best-case throughput number."""
    batches = [queries[i:i + args.batch]
               for i in range(0, len(queries), args.batch)]
    t0 = time.perf_counter()
    results, records = eng.serve(batches)
    total_s = time.perf_counter() - t0

    lat_ms = latency_ms(records)
    fused = sum(1 for r in records if r.n_batches > 1)
    print(f"served {len(queries)} queries in {len(records)} dispatches "
          f"({fused} fused) with algorithm={args.algorithm} impl={args.impl}")
    print(f"throughput: {len(queries)/total_s:,.0f} queries/s   "
          f"latency p50={np.percentile(lat_ms, 50):.2f} ms "
          f"p99={np.percentile(lat_ms, 99):.2f} ms")
    q0 = queries[0][1] if isinstance(queries[0], tuple) else queries[0]
    sample = results[0][0]
    print(f"sample query {q0[:8]}{'...' if len(q0) > 8 else ''} →")
    for rec in sample:
        print(f"  recommend {rec.consequent} "
              f"(conf={rec.confidence:.3f} lift={rec.lift:.2f})")
    record.update({
        "queries_per_s": len(queries) / total_s,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "dispatches": len(records), "fused": fused})


def serve_open_loop(eng, queries, args, controller, record: dict) -> None:
    """Open-loop arrival replay (DESIGN.md §12): virtual arrival clock at
    ``--rate-qps``, real measured dispatch costs, SLO admission + caching."""
    from repro_torch.obs.metrics import get_registry
    srv = OpenLoopServer(
        eng, latency_slo_ms=args.latency_slo_ms, batch=args.batch,
        max_wait_ms=args.max_wait_ms, cache_size=args.cache_size,
        fair_shedding=not args.no_fair_shedding, controller=controller,
        registry=get_registry())   # one server: feed the process snapshot
    rng = np.random.default_rng(args.seed + 2)
    gaps = rng.uniform(0.7, 1.3, len(queries)) / args.rate_qps
    t = 0.0
    for q, gap in zip(queries, gaps):
        t += gap
        if isinstance(q, tuple):
            srv.submit(q[1], t, tenant=q[0])
        else:
            srv.submit(q, t)
    srv.flush()

    s = srv.summary()
    answered = s["served"] + s["cached"]
    makespan = max(srv.busy_until, t)
    slo = ("" if args.latency_slo_ms is None
           else f" vs {args.latency_slo_ms:.1f} ms SLO")
    print(f"open loop @ {args.rate_qps:,.0f} qps offered: "
          f"{answered}/{s['n_queries']} answered "
          f"({s['cached']} cached, {s['shed']} shed = "
          f"{s['shed_rate']:.1%}) in {s['dispatches']} dispatches")
    print(f"sustained: {answered/max(makespan, 1e-9):,.0f} qps   "
          f"latency p50={s['p50_ms']:.2f} ms p99={s['p99_ms']:.2f} ms{slo}")
    record["open_loop"] = {
        "rate_qps": args.rate_qps,
        "latency_slo_ms": args.latency_slo_ms,
        "sustained_qps": answered / max(makespan, 1e-9), **s}
    record["outcomes"] = s
    record["per_query"] = [o.as_dict() for o in srv.outcomes]


if __name__ == "__main__":
    main()
