"""One analyst mining back to back: ``mine()`` of the whole database, again
and again, on one card.

Set-up makes the rows, then runs ``warmup_mines`` mines (the kernel build,
the autotuner's sweep on a fresh checkout, every job shape of the mine).
The window runs whole mines until ``seconds`` have passed; ``mine_s`` is the
window over the mines it completed, each with its levels on the host.  Every
mine's levels are then held against the reference's.
"""

from __future__ import annotations

import time

from portbench.harness.result import Outcome
from portbench.harness.window import Record, Window

from . import mining


def run(ctx) -> Outcome:
    import torch
    from repro_torch.core.mapreduce import MapReduceRuntime

    config, traffic = ctx.config, ctx.traffic
    rows, db = mining.inputs(config, ctx.seed)
    impl = config["mine"]["impl"]

    def one():
        rt = MapReduceRuntime(device=ctx.device, impl=impl)
        return mining.mine_once(db, config, rt), rt

    for _ in range(traffic["warmup_mines"]):
        one()
    win = Window(ctx.device, ctx.trace)
    t0 = win.open()
    results, dispatches, rows_counted = [], 0, 0
    while True:
        res, rt = one()
        results.append(res.levels)
        dispatches += res.dispatches
        rows_counted += rt.stats.rows_counted
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    win.close()
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(ctx.device).type == "cuda" else 0)

    record = None
    if ctx.trace:
        spans = win.spans()
        record = Record(
            spans=spans,
            counters={"mines": len(results), "dispatches": dispatches,
                      "rows_counted": rows_counted,
                      "frequent": sum(mining.frequent(lv) for lv in results)},
            chips=[win.chip()], window_s=win.seconds,
            work=mining.count_jobs(spans, mining.n_items(config)))
    want = mining.reference(rows, config)
    wrong = mining.check(results, want)
    return Outcome(
        metrics={"mine_s": win.seconds / len(results)}, t_window=t0,
        checks={"itemsets_wrong": (wrong, 0)}, attempted=len(results),
        failed=0, memory_peak=peak, record=record,
        notes=[f"mines {len(results)} in {win.seconds:.6f} s, each held "
               f"against the reference's {mining.frequent(want)} itemsets"])
