"""Find the serving cell's knee: the highest offered rate at which the port
answers with p95 <= the SLO, sheds under 1% and keeps no growing backlog.

    python3 portbench/sweep.py --config mushroom --seconds 8 \
        --rates 1000 2000 3000 4000 5000 6000 7000 8000

Sets the deployment up once (``drivers/open_loop.Service``), then offers
each rate in turn through a fresh server, with the open loop's own clock,
and prints one JSON line a rate.  The serving cell's rate is 4/5 of the
highest rate that passes; it is written into its traffic file by hand, so
no run searches for it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.harness import env  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="mushroom")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    env.setup_paths()
    env.setup_caches()
    import numpy as np

    from portbench.drivers.open_loop import Service, offer, schedule
    with open(os.path.join(env.BENCH, "configs", f"{args.config}.json")) as f:
        config = json.load(f)
    svc = Service(config, args.device)
    slo = config["serve"]["latency_slo_ms"]
    rng = np.random.default_rng(args.seed)
    offer(svc.server(), *schedule(rng, args.rates[0], 1.0, svc.slices))
    for rate in args.rates:
        due, tenants, baskets = schedule(rng, rate, args.seconds, svc.slices)
        got = offer(svc.server(), due, tenants, baskets)
        ok = ~np.isnan(got["done"])
        lat = (got["done"][ok] - (got["t0"] + due[ok])) * 1e3
        q = len(due) // 4
        late_first = float(np.median(got["late"][:q])) * 1e3
        late_last = float(np.median(got["late"][-q:])) * 1e3
        shed = 1.0 - ok.mean()
        row = {"rate_qps": rate, "queries": len(due),
               "p50_ms": float(np.percentile(lat, 50)),
               "p95_ms": float(np.percentile(lat, 95)),
               "shed_pct": 100.0 * shed,
               "late_median_first_quarter_ms": late_first,
               "late_median_last_quarter_ms": late_last,
               "sustained_qps": ok.sum() / (got["t1"] - got["t0"])}
        row["passes"] = bool(row["p95_ms"] <= slo and shed < 0.01
                             and late_last < late_first + 5.0)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
