"""CLI: validate metrics snapshots against the versioned schema — the
port's copy of the JAX package's ``obs/validate.py``.

  PYTHONPATH=src python -m repro_torch.obs.validate metrics.json [more.json ...]

Exit code 0 when every snapshot conforms to the schema version it declares
(DESIGN.md §13); nonzero with per-file error listings otherwise.  The
snapshots are the ``--metrics-out`` files of the port's CLIs (the format is
the JAX package's), so schema drift fails a check instead of silently
breaking downstream dashboards.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.metrics import validate_snapshot


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="validate metrics snapshot JSON against the versioned "
                    "schema (DESIGN.md §13)")
    ap.add_argument("paths", nargs="+", help="metrics snapshot JSON file(s)")
    args = ap.parse_args(argv)

    failed = 0
    for path in args.paths:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"{path}: UNREADABLE — {e}")
            failed += 1
            continue
        errs = validate_snapshot(doc)
        if errs:
            failed += 1
            print(f"{path}: INVALID ({len(errs)} error"
                  f"{'s' if len(errs) != 1 else ''})")
            for e in errs:
                print(f"  - {e}")
        else:
            n = (len(doc.get("counters", {})) + len(doc.get("gauges", {}))
                 + len(doc.get("histograms", {})))
            print(f"{path}: ok (schema v{doc['schema_version']}, "
                  f"{n} series)")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
