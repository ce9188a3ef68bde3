"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 portbench/run.py --workload mine.c20d200k --seed 7 --seconds 10 \
        --trace 0

Makes the cell's inputs from ``--seed``, sets up and warms up the port
(``repro_torch``), measures for ``--seconds``, checks every answer of the
window against the plain reference, and prints one JSON line: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics read from the port's spans and counters and the device
trace.  Exits non-zero, with no result, without the cards the cell needs or
when JAX or the JAX package ``repro`` was loaded.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.harness import env  # noqa: E402

T_PROCESS = env.process_start()


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, its configuration and traffic mix, the
    seed, the window's length, whether to trace, and the device (``cuda``;
    the CPU tests pass ``cpu``)."""
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"


def run(ctx: Context, manifest, t_process: float):
    """Drive the cell and build its result line (without printing it)."""
    from portbench.harness import manifest as mf
    from portbench.harness.result import line

    outcome = mf.driver(ctx.traffic["driver"]).run(ctx)
    chips = int(ctx.cell["chips"])
    device = device_info(ctx.device, chips, outcome.memory_peak)
    breakdown = None
    if ctx.trace:
        rec = outcome.record
        metrics = {}
        for m in manifest.per_layer(ctx.cell):
            value = mf.reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device["busy_s"] = sum(c["busy_s"] for c in rec.chips) / len(rec.chips)
        device["window_s"] = rec.window_s
        lead = rec.chips[0]
        breakdown = {"device_ops": lead["device_ops"],
                     "idle_gaps": lead["idle_gaps"]}
    else:
        values = dict(outcome.metrics,
                      setup_s=outcome.t_window - t_process)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in manifest.end_to_end(ctx.cell)}
    return line(outcome, metrics, device, breakdown), outcome.notes


def device_info(device: str, chips: int, peak: int) -> dict:
    import torch
    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": int(peak)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    env.setup_paths()
    env.setup_caches()
    from portbench.harness import manifest as mf
    from portbench.harness.result import emit

    manifest = mf.Manifest()
    cell = manifest.cell(args.workload)
    traffic = mf.traffic(cell["traffic"])
    env.require_cards(int(cell["chips"]))
    ctx = Context(cell=cell, config=manifest.config(cell), traffic=traffic,
                  seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace))
    result, notes = run(ctx, manifest, T_PROCESS)
    loaded = env.forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    emit(result, notes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
