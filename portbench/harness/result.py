"""A run's outcome, and the one JSON line it prints."""

from __future__ import annotations

import dataclasses
import json
import sys


@dataclasses.dataclass
class Outcome:
    """What a driver hands back.

    ``metrics``: end-to-end values by name (host clock).  ``t_window``: the
    window's start on ``time.perf_counter``.  ``checks``: each number the
    correctness check compared, as ``(value, limit)``; the run is correct
    when every value is at most its limit.  ``record``: the traced window's
    :class:`~portbench.harness.window.Record` (None untraced).
    """
    metrics: dict
    t_window: float
    checks: dict
    attempted: int
    failed: int
    memory_peak: int
    record: object = None
    notes: list = dataclasses.field(default_factory=list)

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.checks.values())


def line(outcome: Outcome, metrics: dict, device: dict,
         breakdown: dict | None) -> dict:
    out = {"correct": outcome.correct, "attempted": int(outcome.attempted),
           "failed": int(outcome.failed), "metrics": metrics,
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in outcome.checks.items()}
    return out


def emit(result: dict, notes: list) -> None:
    """Notes, then each compared number beside its limit as the last lines
    of standard error; the result as the last line of standard output."""
    for n in notes:
        print(n, file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
