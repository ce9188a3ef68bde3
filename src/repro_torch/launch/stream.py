"""CLI: continuous mine → rules → serve over a streaming transaction window,
on the port.

  PYTHONPATH=src python -m repro_torch.launch.stream --dataset mushroom \
      --scale 0.12 --min-sup 0.4 --capacity 512 --batch 16 --updates 32 \
      [--device cpu]

Feeds the dataset through a sliding (or landmark) window in micro-batches
(DESIGN.md §8): each update runs the O(delta) signed counting path — falling
back to policy-driven full re-mining on structural drift or staleness — and
atomically swaps a fresh RuleSet into the live serving engine whenever the
frequent itemsets change.  Optionally replays recommendation queries against
the live engine after every update and reports the path mix, update
throughput and rule-refresh latency percentiles.  ``--device cuda`` (the
default) needs a card and raises without one.
"""

from __future__ import annotations

import argparse
import collections
import json
import time

import numpy as np

from repro_torch.core.policy import ALGORITHMS
from repro_torch.data import dataset_by_name, load_transactions
from repro_torch.launch.cliopts import (add_obs_args, add_policy_args,
                                        policy_kwargs_from_args,
                                        tracer_from_args, write_obs_outputs)
from repro_torch.launch.serve_rules import make_queries
from repro_torch.serving.common import latency_percentiles
from repro_torch.stream import StreamMiner
from repro_torch.stream.miner import STREAM_IMPLS


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="mushroom",
                    help="named synthetic dataset (c20d10k/chess/mushroom/...)")
    ap.add_argument("--input", default=None, help="FIMI-format transaction file")
    ap.add_argument("--scale", type=float, default=0.12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--min-sup", type=float, default=0.4)
    ap.add_argument("--min-conf", type=float, default=0.7)
    ap.add_argument("--capacity", type=int, default=512)
    ap.add_argument("--mode", default="sliding", choices=("sliding", "landmark"))
    ap.add_argument("--batch", type=int, default=16,
                    help="transactions per streaming micro-batch")
    ap.add_argument("--updates", type=int, default=32,
                    help="steady-state micro-batch updates to stream")
    ap.add_argument("--algorithm", default="optimized_etdpc",
                    choices=sorted(ALGORITHMS), help="full re-mine driver")
    ap.add_argument("--impl", default="auto", choices=STREAM_IMPLS,
                    help="delta-counting impl (default auto)")
    ap.add_argument("--staleness-factor", type=float, default=1.0)
    ap.add_argument("--track-margin", type=float, default=0.1)
    ap.add_argument("--top-k", type=int, default=5)
    ap.add_argument("--queries-per-update", type=int, default=8,
                    help="live recommendation queries after each update (0=off)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (hand-written kernels) or cpu "
                         "(their plain versions)")
    ap.add_argument("--json-out", default=None)
    add_policy_args(ap)
    add_obs_args(ap)
    args = ap.parse_args(argv)
    tracer = tracer_from_args(args)

    if args.input:
        txns, n_items = load_transactions(args.input)
    else:
        txns, n_items = dataset_by_name(args.dataset, seed=args.seed,
                                        scale=args.scale)
    if not txns:
        print("empty dataset; nothing to stream")
        return

    miner = StreamMiner(
        n_items, args.min_sup, capacity=args.capacity, mode=args.mode,
        algorithm=args.algorithm, min_confidence=args.min_conf,
        impl=args.impl, staleness_factor=args.staleness_factor,
        track_margin=args.track_margin,
        policy_kwargs=policy_kwargs_from_args(args, args.algorithm),
        serve_kwargs={"top_k": args.top_k}, device=args.device)

    # prefill: bring the window to capacity (one re-mine builds the tables)
    fill = min(len(txns), args.capacity)
    t0 = time.perf_counter()
    rec = miner.push(txns[:fill])
    print(f"prefill: {fill} txns → {rec.n_frequent} frequent itemsets, "
          f"{rec.n_rules} rules ({rec.path}, {rec.update_seconds:.2f}s)")

    queries = (make_queries(txns, args.queries_per_update * args.updates,
                            seed=args.seed + 1)
               if args.queries_per_update else [])
    paths: collections.Counter = collections.Counter()
    served = 0
    t_stream = time.perf_counter()
    for u in range(args.updates):
        lo = (fill + u * args.batch) % max(len(txns) - args.batch, 1)
        rec = miner.push(txns[lo:lo + args.batch])
        paths[rec.path] += 1
        if args.queries_per_update:
            q = queries[u * args.queries_per_update:
                        (u + 1) * args.queries_per_update]
            served += len(miner.query(q))
    stream_s = time.perf_counter() - t_stream

    ups = [r for r in miner.updates[1:]]
    refresh = [r.refresh_seconds * 1e3 for r in ups if r.levels_changed]
    upd_ms = np.array([r.update_seconds * 1e3 for r in ups])
    print(f"streamed {args.updates} updates × {args.batch} txns in "
          f"{stream_s:.2f}s = {args.updates / stream_s:.1f} updates/s "
          f"({args.updates * args.batch / stream_s:,.0f} txns/s)")
    print(f"paths: {dict(paths)}  re-mines: {miner.n_remines - 1} "
          f"(tracked candidates: {miner.n_tracked})")
    if ups:
        print(f"update latency p50={np.percentile(upd_ms, 50):.1f} ms "
              f"p99={np.percentile(upd_ms, 99):.1f} ms; "
              f"rule refreshes: {len(refresh)} "
              + (f"(p50={np.percentile(refresh, 50):.1f} ms "
                 f"p99={np.percentile(refresh, 99):.1f} ms)" if refresh else ""))
    if args.queries_per_update:
        lat = latency_percentiles(miner.engine.records)
        print(f"served {served} live queries against {miner.engine.n_rules} "
              f"rules (last dispatch p50={lat['p50_ms']:.2f} ms)")
        sample = miner.query([queries[0]])[0]
        for r in sample[:3]:
            print(f"  recommend {r.consequent} "
                  f"(conf={r.confidence:.3f} lift={r.lift:.2f})")
    if args.json_out:
        payload = {
            "updates_per_s": args.updates / stream_s,
            "paths": dict(paths), "n_remines": miner.n_remines,
            "n_frequent": miner.n_frequent, "n_rules": miner.engine.n_rules,
            "update_p50_ms": float(np.percentile(upd_ms, 50)) if ups else 0.0,
            "update_p99_ms": float(np.percentile(upd_ms, 99)) if ups else 0.0,
            # controller telemetry, in the same shape mine/serve_rules emit —
            # `report --decisions` accepts this file directly
            "decisions": miner.controller.decision_rows(),
        }
        with open(args.json_out, "w") as f:
            json.dump(payload, f, indent=2)
    write_obs_outputs(args, tracer)


if __name__ == "__main__":
    main()
