"""The cost model's store, written behind the observations: at most one
write every ``SAVE_INTERVAL_S`` and one at exit, with the fits in memory,
their predictions and the controller's decisions the same as a model that
never persists.  Times come from an injected clock; nothing sleeps."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

from repro_torch.costmodel import CostController, CostModel
from repro_torch.costmodel.model import SAVE_INTERVAL_S
from repro_torch.obs.clock import FakeClock
from repro_torch.obs.metrics import get_registry, set_registry

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


@pytest.fixture(autouse=True)
def _store(tmp_path, monkeypatch):
    """Every write of these tests lands in ``tmp_path``, and the counters
    start from zero."""
    path = tmp_path / "costmodel.json"
    monkeypatch.setenv("REPRO_TORCH_COSTMODEL_CACHE", str(path))
    old = get_registry()
    set_registry(None)
    yield path
    set_registry(old)


def _disk(path) -> dict:
    with open(path) as f:
        return json.load(f)


def _fits(model) -> dict:
    return {k: f.as_dict() for k, f in model._fits.items()}


def _count_writes(model) -> list:
    """Record each write ``model`` makes (the store's ``save``)."""
    writes = []
    save = model._store.save
    model._store.save = lambda store: (writes.append(store), save(store))
    return writes


@pytest.mark.parametrize("n", [2, 7, 40])
def test_observations_within_an_interval_write_once(_store, n):
    clock = FakeClock(10.0)
    model = CostModel(clock=clock)
    writes = _count_writes(model)
    for i in range(n):
        model.observe("cpu:count:x", 100.0 + i, 0.01)
        clock.advance(0.9 * SAVE_INTERVAL_S / n)
    assert len(writes) == 1                       # the first, at once
    assert _disk(_store)["fits"]["cpu:count:x"]["n"] == 1
    clock.advance(0.2 * SAVE_INTERVAL_S)          # past the interval
    model.observe("cpu:count:x", 50.0, 0.01)
    assert len(writes) == 2
    assert _disk(_store)["fits"] == _fits(model)
    model.observe("cpu:count:x", 60.0, 0.01)      # the interval restarts
    assert len(writes) == 2
    model.flush()
    model.flush()                                 # nothing newer: no write
    assert len(writes) == 3
    assert _disk(_store)["fits"] == _fits(model)


def _script(ctl: CostController, clock: FakeClock) -> list:
    """A fixed run of observations and decisions through ``ctl``."""
    ctl.set_count_context(n_txns=4000, n_words=4, impl="matmul")
    answers = []
    for i, c in enumerate([300, 1200, 800, 2400, 150, 5000]):
        ctl.observe_count(c, 1e-4 + 2e-7 * c + 1e-6 * (i % 3))
        clock.advance(0.37)
        answers.append(ctl.predict_count(1000))
    ctl.observe_spec(3e-4)
    answers.append(ctl.should_speculate(2000))
    answers.append(ctl.choose_width(
        SimpleNamespace(n_candidates=1200, n_frequent_last=300, elapsed=0.01),
        SimpleNamespace(n_candidates=800, n_frequent_last=400, elapsed=0.01)))
    for q in range(1, 9):
        answers.append(ctl.should_admit(work=1e5 * q, latency_slo_s=0.004)[0])
        ctl.observe_serve(1e5, q, 5e-4 + 1e-4 * q)
        clock.advance(0.21)
        answers.append(ctl.choose_fusion(work_per_unit=1e5, queued=6,
                                         max_fuse=4, latency_budget_s=0.002))
    ctl.observe_remine(8000, 0.05)
    answers.append(ctl.should_remine(drift=0.3, staleness_seconds=2.0,
                                     window_rows=9000, staleness_factor=1.0))
    return answers


def test_persisting_changes_no_fit_prediction_or_decision(_store):
    runs = {}
    for persist in (False, True):
        clock = FakeClock(0.0)
        model = CostModel(persist=persist, clock=clock)
        ctl = CostController(model, device="cpu")
        answers = _script(ctl, clock)
        keys = sorted(model._fits)
        runs[persist] = (
            _fits(model), answers,
            [d.as_dict() for d in ctl.decisions],
            [(model.predict(k, 1234.0), model.overhead(k),
              model.n_samples(k)) for k in keys])
    assert runs[True] == runs[False]
    assert runs[True][2]                          # decisions were taken


def _python(code: str, store, **env):
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=240, check=True,
        env={**os.environ, "PYTHONPATH": SRC,
             "REPRO_TORCH_COSTMODEL_CACHE": str(store), **env})


CHILD = """
import json
from repro_torch.costmodel import CostModel
from repro_torch.obs.clock import FakeClock
model = CostModel(clock=FakeClock(0.0))        # time never passes
for i in range(1, 25):
    model.observe(f"cpu:k{i % 4}:count", 10.0 * i, 1e-3 * i + 1e-5 * i * i)
print(json.dumps({k: f.as_dict() for k, f in model._fits.items()}))
"""


def test_a_process_that_exits_leaves_its_final_fits(_store):
    out = _python(CHILD, _store)
    final = json.loads(out.stdout)
    assert len(final) == 4 and sum(f["n"] for f in final.values()) == 24
    assert _disk(_store)["fits"] == final         # the exit hook wrote it
    warm = CostModel(persist=True)
    assert _fits(warm) == final
    assert os.listdir(_store.parent) == [_store.name]


def test_a_model_flushes_to_the_store_it_was_made_with(_store, tmp_path,
                                                       monkeypatch):
    model = CostModel(clock=FakeClock(0.0))
    model.observe("cpu:count:x", 100.0, 0.01)
    model.observe("cpu:count:x", 200.0, 0.02)
    other = tmp_path / "elsewhere" / "costmodel.json"
    monkeypatch.setenv("REPRO_TORCH_COSTMODEL_CACHE", str(other))
    model.flush()
    assert _disk(_store)["fits"]["cpu:count:x"]["n"] == 2
    assert not other.exists()


WRITER = """
import json, os, sys, time
from repro_torch.costmodel import CostModel
from repro_torch.obs.clock import FakeClock
me, n = int(sys.argv[1]), 100
model = CostModel(clock=FakeClock(0.0))
# both have loaded the (empty) store before either writes
ready = os.environ["READY"]
open(f"{ready}.{me}", "w").close()
deadline = time.monotonic() + 120
while not os.path.exists(f"{ready}.{1 - me}") and time.monotonic() < deadline:
    pass
for i in range(400):
    model.observe(f"cpu:w{me}:{i}", 1.0 + i, 1e-3)
for i in range(n):
    model.observe(f"cpu:w{me}:{i}", 2.0 + i, 2e-3)
    model.flush()
    with open(os.environ["REPRO_TORCH_COSTMODEL_CACHE"]) as f:
        json.load(f)           # a reader between writes sees a whole store
"""


def test_two_processes_flushing_one_store_leave_valid_json(_store, tmp_path):
    ready = str(tmp_path / "ready")
    env = {**os.environ, "PYTHONPATH": SRC, "READY": ready,
           "REPRO_TORCH_COSTMODEL_CACHE": str(_store)}
    procs = [subprocess.Popen([sys.executable, "-c", WRITER, str(me)],
                              env=env, stderr=subprocess.PIPE, text=True)
             for me in (0, 1)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
    disk = _disk(_store)
    assert disk["schema"] == CostModel.SCHEMA
    # one writer's whole store, never a mix of the two
    (writer,) = {k.split(":")[1] for k in disk["fits"]}
    assert writer in ("w0", "w1") and len(disk["fits"]) == 400
    assert sorted(os.listdir(_store.parent)) == sorted(
        [_store.name, "ready.0", "ready.1"])


def test_the_counters_count_observations_and_writes(_store):
    clock = FakeClock(0.0)
    model = CostModel(clock=clock)
    quiet = CostModel(persist=False, clock=clock)
    for _ in range(5):
        model.observe("cpu:count:x", 100.0, 0.01)
        quiet.observe("cpu:count:x", 100.0, 0.01)
        clock.advance(0.3 * SAVE_INTERVAL_S)
    reg = get_registry()
    # writes at 0 and 1.2 intervals; the model without a store counts nothing
    assert reg.value("costmodel.observations") == 5
    assert reg.value("costmodel.saves") == 2
    model.flush()                 # the write at 1.2 left nothing newer
    quiet.flush()
    assert reg.value("costmodel.saves") == 2
    model.observe("cpu:count:x", 100.0, 0.01)
    model.flush()
    assert reg.value("costmodel.observations") == 6
    assert reg.value("costmodel.saves") == 3
