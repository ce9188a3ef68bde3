"""The readers of the spans inside generation, the counting job's wait, the
cost model's store write and serving's dispatch and queue, on a record with
those spans and on one without them.

A traced run's per-layer line is read with the benchmark's files of the
newer checkout over both programs, so a reader has to work on a program
that lacks what it reads: there it returns None, the line leaves its metric
out, and every other reader reads as before.  The record without the spans
is a CPU traced run of the cell with every span of those names taken out.
"""

import dataclasses
import json
import math

import pytest

from portbench.harness import manifest as mf
from portbench.harness.window import Record
from portbench.tests.helpers import context

MINE_CELLS = ["mine.c20d200k", "mine.mushroom"]
SERVE_CELL = "serve.mushroom-4t"

# the spans the readers below read, and the readers, by kind of cell
NEW_SPANS = {"mine.join", "mine.prune", "mine.count_wait", "costmodel.save",
             "serve.pack", "serve.score", "serve.fetch", "serve.decode",
             "serve.batch", "serve.submit"}
NEW_READERS = {
    "mine": ["join_pct.mine", "prune_pct.mine", "count_wait_pct.mine",
             "costmodel_pct.mine"],
    "serve": ["pack_ms.serve", "score_ms.serve", "fetch_ms.serve",
              "decode_ms.serve", "queue_wait_p50_ms.serve",
              "costmodel_ms.serve"],
}


def _traced(cell: str) -> tuple:
    man, ctx = context(cell)
    ctx = dataclasses.replace(ctx, trace=True)
    outcome = mf.driver(ctx.traffic["driver"]).run(ctx)
    assert outcome.correct
    return man, man.cell(cell), outcome.record


@pytest.fixture(scope="module", params=MINE_CELLS + [SERVE_CELL])
def traced(request):
    return _traced(request.param)


def _without_new_spans(rec: Record) -> Record:
    return dataclasses.replace(
        rec, spans=[s for s in rec.spans if s[0] not in NEW_SPANS])


def _without_attrs(rec: Record) -> Record:
    """The new spans kept, stripped of every attribute."""
    return dataclasses.replace(
        rec, spans=[(n, t0, t1, {} if n in NEW_SPANS else a)
                    for n, t0, t1, a in rec.spans])


def _line_metrics(man, cell, rec) -> dict:
    """The per-layer part of the line ``run.py`` prints for ``rec``."""
    out = {}
    for m in man.per_layer(cell):
        value = mf.reader(m["name"])(rec)
        if value is not None:
            out[m["name"]] = value
    json.dumps(out, allow_nan=False)
    return out


def _new(cell) -> list:
    return NEW_READERS[cell["name"].split(".", 1)[0]]


def test_the_cells_list_their_new_readers():
    man = mf.Manifest()
    for name in MINE_CELLS + [SERVE_CELL]:
        cell = man.cell(name)
        listed = {m["name"] for m in man.per_layer(cell)}
        assert set(_new(cell)) <= listed


def test_new_readers_read_the_new_spans(traced):
    man, cell, rec = traced
    names = {s[0] for s in rec.spans}
    got = _line_metrics(man, cell, rec)
    for name in _new(cell):
        assert name in got, name
        assert math.isfinite(got[name]) and got[name] >= 0, name
    if cell["name"] in MINE_CELLS:
        assert {"mine.join", "mine.prune", "mine.count_wait",
                "costmodel.save"} <= names
        assert got["join_pct.mine"] + got["prune_pct.mine"] <= \
            got["gen_pct.mine"]
    else:
        assert NEW_SPANS - {"mine.join", "mine.prune",
                            "mine.count_wait"} <= names
        inside = sum(got[f"{p}_ms.serve"]
                     for p in ("pack", "score", "fetch", "decode"))
        assert inside <= got["dispatch_ms.serve"]


def test_a_program_without_the_spans_reads_as_before(traced):
    man, cell, rec = traced
    parent = _without_new_spans(rec)
    got = _line_metrics(man, cell, parent)
    for name in _new(cell):
        assert mf.reader(name)(parent) is None, name
    old = [m["name"] for m in man.per_layer(cell)
           if m["name"] not in _new(cell)]
    full = _line_metrics(man, cell, rec)
    assert set(got) == set(old) & set(full)
    assert all(got[name] == full[name] for name in got)


def test_new_spans_without_attributes_raise_nothing(traced):
    man, cell, rec = traced
    got = _line_metrics(man, cell, _without_attrs(rec))
    assert "queue_wait_p50_ms.serve" not in got


def test_an_empty_record_reads_none():
    rec = Record(spans=[], counters={}, chips=[], window_s=1.0, work=[])
    for names in NEW_READERS.values():
        for name in names:
            assert mf.reader(name)(rec) is None, name
