"""The control of ``correct``: the reference put in the port's place, one
step below the precision the configuration states, read by the same checks.

    python3 portbench/control.py --workload mine.c20d200k --seeds 1 2 3

Mining cells: the reference's levels with every support count held in
float16 (a half-precision counter, the step a faster counting kernel would
tempt), against the exact reference: ``itemsets_wrong``.  The serving cell:
the tenants' rule scores computed in bfloat16, and the answers ranked by
them, against the float32 reference, over as many queries as a run offers:
``rules_wrong`` and ``answers_wrong``.  Prints one JSON line a seed.  The
benchmark's runs never run it; it sets the upper reading of each limit
(``PERF.md``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.harness import env  # noqa: E402


def mining_control(config: dict, seed: int) -> dict:
    import numpy as np

    from portbench.drivers import mining
    from portbench.reference import apriori
    rows, _ = mining.inputs(config, seed)
    want = mining.reference(rows, config)
    low = apriori.apriori(rows, config["mine"]["min_sup"],
                          count_dtype=np.float16)
    got = apriori.canonical({k: (apriori.pack_itemsets(i, rows.shape[1]), c)
                             for k, (i, c) in low.items()})
    return {"itemsets_wrong": apriori.mismatches(got, want)}


def serving_control(config: dict, traffic: dict, seconds: float, seed: int,
                    device: str) -> dict:
    import numpy as np
    import torch

    from portbench.data.generators import generate
    from portbench.drivers import open_loop
    from portbench.drivers.open_loop import (reference_answers,
                                             reference_rules, schedule)
    sv = config["serve"]
    rows = generate(config["dataset"])
    slices = {f"t{i}": rows[i::sv["tenants"]] for i in range(sv["tenants"])}
    _, rng = np.random.default_rng(seed).spawn(2)
    _, tenants, baskets = schedule(rng, float(traffic["rate_qps"]), seconds,
                                   slices)
    want_rules = reference_rules(config, slices)
    low_rules = reference_rules(config, slices, score_dtype=torch.bfloat16)
    total = sum(r["ante"].shape[0] for r in want_rules.values())
    fetch = min(sv["top_k"] * 8, total)      # the engine's overfetch of 8
    want = reference_answers(config, want_rules, fetch, tenants, baskets,
                             device)
    low = reference_answers(config, low_rules, fetch, tenants, baskets,
                            device)
    return {"rules_wrong": sum(open_loop.ruleset_mismatches(low_rules[t],
                                                            want_rules[t])
                               for t in slices),
            "answers_wrong": sum(1 for a, b in zip(low, want) if a != b),
            "answers": len(want)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    env.setup_paths()
    from portbench.harness import manifest as mf
    man = mf.Manifest()
    cell = man.cell(args.workload)
    config = man.config(cell)
    traffic = mf.traffic(cell["traffic"])
    for seed in args.seeds:
        if traffic["driver"] == "open_loop":
            out = serving_control(config, traffic,
                                  float(man.doc["run_seconds"]), seed,
                                  args.device)
        else:
            out = mining_control(config, seed)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
