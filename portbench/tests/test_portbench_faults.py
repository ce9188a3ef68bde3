"""A run with the timed path broken underneath comes out not correct: each
fault the cell can have, planted in the port, on the CPU at a small size
(the run skips only the harness's look for a card)."""

import glob
import os

import pytest

from portbench.drivers import mine_mesh
from portbench.tests import faulty
from portbench.tests.helpers import context, run

MINING = [faulty.count_altered, faulty.half_the_rows,
          faulty.phases_unchanged]
SERVING = [faulty.answer_altered, faulty.half_the_queries,
           faulty.dispatch_unchanged]


@pytest.mark.parametrize("cell", ["mine.c20d200k", "mine.mushroom"])
def test_sound_mining_run_is_correct(cell):
    man, ctx = context(cell)
    out = run(man, ctx)
    assert out["correct"] and out["checks"]["itemsets_wrong"]["value"] == 0


@pytest.mark.parametrize("fault", MINING, ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", ["mine.c20d200k", "mine.mushroom"])
def test_mining_fault_is_not_correct(cell, fault):
    man, ctx = context(cell)
    with fault():
        out = run(man, ctx)
    assert not out["correct"]
    assert out["checks"]["itemsets_wrong"]["value"] > 0


@pytest.mark.parametrize("fault", SERVING + [None],
                         ids=lambda f: f.__name__ if f else "sound")
def test_serving_fault_is_not_correct(fault):
    # a rate the CPU cannot keep up with, so dispatches hold many queries
    man, ctx = context("serve.mushroom-4t", rate=1500.0)
    if fault is None:
        out = run(man, ctx)
        assert out["correct"] and out["attempted"] > 20
        return
    with fault():
        out = run(man, ctx)
    assert not out["correct"]
    assert out["checks"]["answers_wrong"]["value"] > 0


def _children() -> list:
    out = []
    for stat in glob.glob("/proc/[0-9]*/stat"):
        try:
            with open(stat) as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == os.getpid():
            out.append(stat)
    return out


def test_mesh_without_the_exchange_is_not_correct(monkeypatch):
    man, ctx = context("mine.c20d200k.x4", seconds=0.5)
    sound = run(man, ctx)
    assert sound["correct"] and sound["device"]["count"] == 4
    assert _children() == []          # workers and spawn's helper ended
    monkeypatch.setattr(mine_mesh, "worker", faulty.no_exchange_worker)
    out = run(man, ctx)
    assert not out["correct"]
    assert out["checks"]["itemsets_wrong"]["value"] > 0
