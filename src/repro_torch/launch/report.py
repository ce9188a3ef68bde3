"""Tables from run records — the port's copy of the JAX package's
``launch/report.py``, stdlib only, in its three modes:

* a dry-run jsonl (``arch``/``shape``/``mesh`` cells): the dry-run status,
  roofline and hillclimb-candidate tables;
* ``--decisions``: the cost-model decision table (DESIGN.md §9) from a jsonl
  of ``CostController.decision_rows`` dicts or any ``--json-out`` file of
  the port's ``mine``, ``stream`` and ``serve_rules`` CLIs;
* ``--trace``: the top-slowest-spans and per-phase breakdown of a
  ``--trace-out`` Chrome-trace file (DESIGN.md §13).

  PYTHONPATH=src python -m repro_torch.launch.report results/dryrun.jsonl
  PYTHONPATH=src python -m repro_torch.launch.report --decisions run.json
  PYTHONPATH=src python -m repro_torch.launch.report --trace trace.json
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict


def fmt_bytes(b):
    return "–" if b is None else f"{b/2**30:.2f}"


def fmt_s(x):
    return "–" if x is None else f"{x:.3e}"


def _giga(x):
    return None if x is None else x / 1e9


def fmt_or_dash(x, fmt="{}"):
    """A value a record leaves null as "–"."""
    return "–" if x is None else fmt.format(x)


def fmt_compile(r) -> str:
    """A cell's compile seconds, or where it has none (the port traces,
    it does not compile) its trace seconds, marked so."""
    if r.get("compile_s") is None and r.get("trace_s") is not None:
        return f"{r['trace_s']:.1f} (trace)"
    return fmt_or_dash(r.get("compile_s"))


def load(path):
    with open(path) as f:
        rows = [json.loads(l) for l in f if l.strip()]
    dedup = {}
    for r in rows:  # last write wins per cell
        dedup[(r["arch"], r["shape"], r["mesh"])] = r
    return dedup


def dryrun_table(cells) -> str:
    out = ["| arch | shape | mesh | status | compile s | temp GiB/dev | "
           "args GiB/dev | HLO GFLOPs (raw) | collectives (per-chip MB) |",
           "|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape, mesh), r in sorted(cells.items()):
        if r.get("skipped"):
            out.append(f"| {arch} | {shape} | {mesh} | SKIP (full-attn) | – | – | – | – | – |")
            continue
        if not r.get("ok"):
            out.append(f"| {arch} | {shape} | {mesh} | **FAIL** | – | – | – | – | – |")
            continue
        coll = ", ".join(f"{k}:{v/2**20:.0f}" for k, v in
                         sorted(r["collectives_by_op"].items()))
        out.append(
            f"| {arch} | {shape} | {mesh} | ok | "
            f"{fmt_compile(r)} | "
            f"{fmt_bytes(r.get('temp_bytes_per_dev'))} | "
            f"{fmt_bytes(r['arg_bytes_per_dev'])} | "
            f"{fmt_or_dash(_giga(r.get('hlo_flops_raw')), '{:.1f}')} | "
            f"{coll or '—'} |")
    return "\n".join(out)


def roofline_table(cells) -> str:
    out = ["| arch | shape | compute s | memory s | collective s | dominant | "
           "MODEL_FLOPS | useful ratio | bound by |",
           "|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape, mesh), r in sorted(cells.items()):
        if mesh != "16x16" or not r.get("ok"):
            continue
        t = r["roofline"]
        bound = {"compute": "MXU/VPU", "memory": "HBM bw",
                 "collective": "ICI"}[t["dominant"]]
        if "trace_s" in r or t.get("collective_s") is None:   # port record
            bound = {"compute": "tensor cores", "memory": "HBM bw",
                     "collective": "NVLink"}[t["dominant"]]
        out.append(
            f"| {arch} | {shape} | {fmt_s(t['compute_s'])} | "
            f"{fmt_s(t['memory_s'])} | {fmt_s(t['collective_s'])} | "
            f"**{t['dominant']}** | {t['model_flops']:.2e} | "
            f"{t['useful_ratio']:.2f} | {bound} |")
    return "\n".join(out)


def pick_hillclimb(cells):
    """worst roofline balance, most collective-bound, most paper-representative."""
    live = {k: v for k, v in cells.items()
            if k[2] == "16x16" and v.get("ok")}
    def frac(r):
        t = r["roofline"]
        dom = max(t["compute_s"], t["memory_s"], t["collective_s"] or 0.0)
        return t["compute_s"] / dom if dom else 0.0
    worst = min(live.items(), key=lambda kv: frac(kv[1]))
    coll = max(live.items(), key=lambda kv: (
        (kv[1]["roofline"]["collective_s"] or 0.0)
        / max(kv[1]["roofline"]["compute_s"], 1e-12)))
    return worst[0], coll[0]


def decision_table(rows) -> str:
    """Per-decision telemetry (CostController.decision_rows dicts): one line
    per adaptive decision — what the model predicted, what was chosen, what
    was then measured, and the prediction error where both are known."""
    out = ["| site | model key | predicted (s) | chosen | measured s | rel err |",
           "|---|---|---|---|---|---|"]
    for r in rows:
        pred = r.get("predicted") or {}
        pred_s = ", ".join(f"{k}:{v:.2e}" for k, v in sorted(pred.items()))
        chosen, measured = r.get("chosen"), r.get("measured")
        err = "–"
        p_chosen = pred.get(str(chosen))
        if p_chosen is not None and measured:
            err = f"{abs(p_chosen - measured) / measured:.2f}"
        m_s = fmt_s(measured) if measured is not None else "–"
        out.append(f"| {r.get('site')} | {r.get('key')} | {pred_s or '—'} | "
                   f"{chosen} | {m_s} | {err} |")
    return "\n".join(out)


def decision_summary(rows) -> str:
    by_site: dict = defaultdict(list)
    for r in rows:
        p = (r.get("predicted") or {}).get(str(r.get("chosen")))
        if p is not None and r.get("measured"):
            by_site[r.get("site")].append(
                abs(p - r["measured"]) / r["measured"])
    lines = [f"{len(rows)} decisions recorded"]
    for site, errs in sorted(by_site.items()):
        lines.append(f"  {site}: {len(errs)} measured, "
                     f"mean |rel err| {sum(errs)/len(errs):.2f}")
    return "\n".join(lines)


def load_decisions(path) -> list:
    """Decision rows from a jsonl stream, a bare JSON list, or any JSON
    object with a ``decisions`` list (e.g. ``launch.mine --json-out``)."""
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except ValueError:
        return [json.loads(l) for l in text.splitlines() if l.strip()]
    return doc.get("decisions", []) if isinstance(doc, dict) else doc


def outcome_table(summary: dict) -> str:
    """Admission-telemetry roll-up (``serving.outcome_summary`` dict): the
    overall served/cached/shed split plus the per-tenant fairness view."""
    lines = [
        f"{summary.get('n_queries', 0)} queries: "
        f"{summary.get('served', 0)} served, "
        f"{summary.get('cached', 0)} cached, "
        f"{summary.get('shed', 0)} shed "
        f"(shed rate {summary.get('shed_rate', 0.0):.1%}, "
        f"cache hit rate {summary.get('cache_hit_rate', 0.0):.1%}); "
        f"answered p50 {summary.get('p50_ms', 0.0):.2f} ms / "
        f"p99 {summary.get('p99_ms', 0.0):.2f} ms",
        "", "| tenant | offered | answered | shed | shed rate |",
        "|---|---|---|---|---|"]
    for tenant, row in sorted((summary.get("tenants") or {}).items()):
        rate = row["shed"] / row["offered"] if row["offered"] else 0.0
        lines.append(f"| {tenant} | {row['offered']} | {row['answered']} | "
                     f"{row['shed']} | {rate:.1%} |")
    return "\n".join(lines)


def load_trace(path) -> list:
    """Events from a Chrome-trace-event file (object format or bare array)."""
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    return [e for e in events if isinstance(e, dict)]


def trace_spans(events) -> list:
    """Complete ("X") spans with per-span *self* time — duration minus the
    time covered by nested spans on the same (pid, tid) track, recovered
    from interval containment (the Chrome format keeps no explicit tree)."""
    spans = [dict(e) for e in events if e.get("ph") == "X"]
    by_track: dict = defaultdict(list)
    for s in spans:
        s["child_us"] = 0.0
        by_track[(s.get("pid"), s.get("tid"))].append(s)
    for track in by_track.values():
        track.sort(key=lambda s: (s["ts"], -float(s.get("dur", 0.0))))
        stack: list = []
        for s in track:
            while stack and (stack[-1]["ts"] + float(stack[-1].get("dur", 0.0))
                             <= s["ts"] + 1e-9):
                stack.pop()
            if stack:
                stack[-1]["child_us"] += float(s.get("dur", 0.0))
            stack.append(s)
    for s in spans:
        s["self_us"] = max(float(s.get("dur", 0.0)) - s["child_us"], 0.0)
    return spans


def trace_slowest_table(spans, top: int = 15) -> str:
    """Top-N slowest spans by duration."""
    out = ["| span | dur ms | self ms | attrs |", "|---|---|---|---|"]
    ranked = sorted(spans, key=lambda s: -float(s.get("dur", 0.0)))[:top]
    for s in ranked:
        attrs = ", ".join(
            f"{k}={v:.3g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in sorted((s.get("args") or {}).items())[:4])
        out.append(f"| {s.get('name')} | {float(s.get('dur', 0.0))/1e3:.2f} | "
                   f"{s['self_us']/1e3:.2f} | {attrs or '—'} |")
    return "\n".join(out)


def trace_phase_table(spans) -> str:
    """Per-span-name time breakdown (count, total, self, mean)."""
    agg: dict = defaultdict(lambda: [0, 0.0, 0.0])
    for s in spans:
        a = agg[s.get("name")]
        a[0] += 1
        a[1] += float(s.get("dur", 0.0))
        a[2] += s["self_us"]
    total_self = sum(a[2] for a in agg.values()) or 1.0
    out = ["| phase | n | total ms | self ms | mean ms | self % |",
           "|---|---|---|---|---|---|"]
    for name, (n, dur, self_us) in sorted(agg.items(),
                                          key=lambda kv: -kv[1][2]):
        out.append(f"| {name} | {n} | {dur/1e3:.2f} | {self_us/1e3:.2f} | "
                   f"{dur/n/1e3:.2f} | {self_us/total_self:.1%} |")
    return "\n".join(out)


def report_trace(path, top: int = 15):
    events = load_trace(path)
    spans = trace_spans(events)
    if not spans:
        print(f"{path}: no complete spans found")
        return
    n_inst = sum(1 for e in events if e.get("ph") == "i")
    print(f"## Trace {path}: {len(spans)} spans, {n_inst} events\n")
    print(f"### Top {min(top, len(spans))} slowest spans\n")
    print(trace_slowest_table(spans, top))
    print()
    print("### Per-phase time breakdown\n")
    print(trace_phase_table(spans))


def report_decisions(path):
    rows = load_decisions(path)
    print(f"## Cost-model decisions ({path})\n")
    if not rows:
        print("no decision rows found — pass a decisions jsonl or a "
              "--json-out file from mine/stream/serve_rules")
        return
    print(decision_summary(rows))
    print()
    print(decision_table(rows))
    try:
        with open(path) as f:
            doc = json.load(f)
    except ValueError:
        doc = None
    if isinstance(doc, dict) and doc.get("outcomes"):
        print()
        print("## Admission outcomes\n")
        print(outcome_table(doc["outcomes"]))


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("path", nargs="?", default="results/dryrun.jsonl")
    ap.add_argument("--decisions", metavar="JSONL", default=None,
                    help="render the cost-model decision telemetry table from "
                         "a jsonl of CostController.decision_rows dicts or a "
                         "mine/stream/serve_rules --json-out file")
    ap.add_argument("--trace", metavar="JSON", default=None,
                    help="render top-slowest-spans + per-phase breakdown "
                         "from a --trace-out Chrome-trace file")
    ap.add_argument("--top", type=int, default=15,
                    help="rows in the --trace slowest-spans table")
    args = ap.parse_args(argv)
    if args.trace:
        report_trace(args.trace, top=args.top)
        return
    if args.decisions:
        report_decisions(args.decisions)
        return
    cells = load(args.path)
    n_ok = sum(1 for r in cells.values() if r.get("ok"))
    n_skip = sum(1 for r in cells.values() if r.get("skipped"))
    n_fail = len(cells) - n_ok - n_skip
    print(f"## Dry-run status: {n_ok} ok / {n_skip} skipped / {n_fail} failed "
          f"({len(cells)} cells)\n")
    print(dryrun_table(cells))
    print()
    print("## Roofline (single-pod 16×16)\n")
    print(roofline_table(cells))
    print()
    worst, coll = pick_hillclimb(cells)
    print(f"hillclimb candidates: worst-fraction={worst}, most-collective={coll}")


if __name__ == "__main__":
    main()
