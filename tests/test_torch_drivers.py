"""The port's mining path against the JAX package's, end to end on the CPU.

Both packages mine the same numpy inputs; levels (masks and counts) must be
byte-identical, and equal to the sequential oracle, for every algorithm and
every counting family.  The deterministic policies must also schedule the
same jobs: dispatches, counted rows and result bytes agree.  Checkpoints
written by either package resume in the other.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.core.mapreduce as ref_mapreduce
import repro.costmodel as ref_costmodel
import repro.costmodel.model as ref_model
import repro.roofline as ref_roofline
from repro.core.policy import PhaseStats as RefPhaseStats
from repro.obs.metrics import validate_snapshot
from repro_torch import roofline
from repro_torch.core import (ALGORITHMS, IMPLS, MapReduceRuntime, mine,
                              sequential_apriori)
from repro_torch.core.bitset import (pack_itemsets, singleton_masks,
                                     unpack_itemsets)
from repro_torch.core.phases import bucket_pad
from repro_torch.core.policy import PhaseStats
from repro_torch.costmodel import CostController, device_key
from repro_torch.costmodel.measure import cache_dir, time_once
from repro_torch.costmodel.model import CostModel
from repro_torch.obs.clock import FakeClock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALGOS = sorted(ALGORITHMS)
DETERMINISTIC = ["fpc", "optimized_vfpc", "spc", "vfpc"]
N_ITEMS, MIN_SUP = 24, 0.25
NO_STRAGGLERS = 1e9   # spec_factor that never re-dispatches a phase


def _mk_txns(seed, n_items=N_ITEMS, n_txns=200, density=0.3):
    """The ``test_drivers.py`` dataset."""
    rng = np.random.default_rng(seed)
    base = rng.random((4, n_items)) < density * 1.5
    txns = []
    for _ in range(n_txns):
        pat = base[rng.integers(4)]
        row = np.where(rng.random(n_items) < 0.85, pat,
                       rng.random(n_items) < density / 2)
        t = np.nonzero(row)[0].tolist()
        txns.append(t if t else [int(rng.integers(n_items))])
    return txns


def _ref_mine(txns, impl="vertical", **kw):
    rt = ref_mapreduce.MapReduceRuntime(impl=impl, autotune=False)
    kw.setdefault("spec_factor", NO_STRAGGLERS)
    return ref_core.mine(txns, n_items=N_ITEMS, min_sup=MIN_SUP, runtime=rt,
                         **kw)


def _port_mine(txns, impl="vertical", **kw):
    kw.setdefault("spec_factor", NO_STRAGGLERS)
    return mine(txns, n_items=N_ITEMS, min_sup=MIN_SUP,
                runtime=MapReduceRuntime(impl=impl, device="cpu"), **kw)


def _assert_levels_equal(got, want, ctx=""):
    assert got.keys() == want.keys(), ctx
    for k in want:
        np.testing.assert_array_equal(got[k][0], want[k][0],
                                      err_msg=f"{ctx}: masks at k={k}")
        np.testing.assert_array_equal(got[k][1], want[k][1],
                                      err_msg=f"{ctx}: counts at k={k}")
        assert got[k][0].dtype == want[k][0].dtype
        assert got[k][1].dtype == want[k][1].dtype


@pytest.fixture(scope="module")
def dataset():
    txns = _mk_txns(0)
    return txns, sequential_apriori(txns, MIN_SUP)


@pytest.fixture(scope="module")
def reference_levels(dataset):
    txns, _ = dataset
    return {algo: _ref_mine(txns, algorithm=algo).levels for algo in ALGOS}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("algo", ALGOS)
def test_levels_equal_reference_and_oracle(dataset, reference_levels, algo,
                                           impl):
    txns, oracle = dataset
    res = _port_mine(txns, impl=impl, algorithm=algo)
    _assert_levels_equal(res.levels, reference_levels[algo], f"{algo}/{impl}")
    assert res.itemsets() == oracle


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("algo", DETERMINISTIC)
def test_runtime_stats_equal_reference(dataset, algo, impl):
    """Same jobs, same rows, same bytes home: the port schedules exactly
    what the reference schedules on one device (the reference impl of the
    same name is its jnp form of this family)."""
    txns, _ = dataset
    ref_rt = ref_mapreduce.MapReduceRuntime(impl=impl, autotune=False)
    ref = ref_core.mine(txns, n_items=N_ITEMS, min_sup=MIN_SUP,
                        algorithm=algo, runtime=ref_rt,
                        spec_factor=NO_STRAGGLERS)
    rt = MapReduceRuntime(impl=impl, device="cpu")
    got = mine(txns, n_items=N_ITEMS, min_sup=MIN_SUP, algorithm=algo,
               runtime=rt, spec_factor=NO_STRAGGLERS)
    _assert_levels_equal(got.levels, ref.levels, f"{algo}/{impl}")
    for field in ("dispatches", "rows_counted", "bytes_to_host",
                  "fused_dispatches", "compiles"):
        assert getattr(rt.stats, field) == getattr(ref_rt.stats, field), field
    assert [p.candidate_counts for p in got.phases] == \
        [p.candidate_counts for p in ref.phases]


@pytest.mark.parametrize("impl", IMPLS)
def test_fused_equals_unfused(dataset, impl):
    txns, oracle = dataset
    fused = _port_mine(txns, impl=impl, algorithm="optimized_vfpc")
    unfused = _port_mine(txns, impl=impl, algorithm="optimized_vfpc",
                         pipeline=False)
    ref_unfused = _ref_mine(txns, algorithm="optimized_vfpc", pipeline=False)
    _assert_levels_equal(unfused.levels, fused.levels, impl)
    _assert_levels_equal(unfused.levels, ref_unfused.levels, impl)
    assert unfused.itemsets() == oracle


def _item_counts(db, n_items):
    out = np.zeros(n_items, np.int64)
    for items in unpack_itemsets(db):
        out[list(items)] += 1
    return out


def test_phase_count_unfused_and_fused_results(dataset):
    """The runtime's two job forms: every padded row's count, or the keep
    mask and filtered counts of the real rows only."""
    txns, _ = dataset
    db = pack_itemsets(txns, N_ITEMS)
    padded = bucket_pad(singleton_masks(N_ITEMS))
    for impl in IMPLS:
        rt = MapReduceRuntime(impl=impl, device="cpu")
        dev = rt.scatter_db(db, n_items=N_ITEMS)
        counts = rt.phase_count(dev, padded)
        assert counts.shape == (padded.shape[0],)
        np.testing.assert_array_equal(counts[:N_ITEMS],
                                      _item_counts(db, N_ITEMS))
        assert (counts[N_ITEMS:] == len(txns)).all()    # empty rows
        keep, fc = rt.phase_count_filtered(dev, padded, min_count=50,
                                           n_valid=N_ITEMS)
        assert keep.shape == fc.shape == (N_ITEMS,)
        np.testing.assert_array_equal(keep, counts[:N_ITEMS] >= 50)
        np.testing.assert_array_equal(fc, np.where(keep, counts[:N_ITEMS], 0))
        keep2, none = rt.phase_count_filtered(dev, padded, min_count=50,
                                              with_counts=False,
                                              n_valid=N_ITEMS)
        assert none is None
        np.testing.assert_array_equal(keep2, keep)


# -- checkpoints, retries, stragglers ----------------------------------------------

def _stop_after_job1(event, k):
    if event == "count_dispatch" and k > 1:
        raise RuntimeError("stopped after Job1")


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, dataset, writer):
    """A run stopped after Job1 by one package resumes in the other: the
    resumed run skips Job1 and ends with the uninterrupted run's levels."""
    txns, oracle = dataset
    d = str(tmp_path / "ck")
    first, second = ((_ref_mine, _port_mine) if writer == "reference"
                     else (_port_mine, _ref_mine))
    with pytest.raises(RuntimeError, match="stopped after Job1"):
        first(txns, algorithm="optimized_vfpc", checkpoint_dir=d,
              count_hook=_stop_after_job1, max_retries=0)
    assert os.path.exists(os.path.join(d, "mining_state.npz"))
    resumed = second(txns, algorithm="optimized_vfpc", checkpoint_dir=d)
    assert resumed.phases[0].k_start == 2
    full = _ref_mine(txns, algorithm="optimized_vfpc")
    _assert_levels_equal(resumed.levels, full.levels, writer)
    assert resumed.itemsets() == oracle


def test_checkpoint_resume_after_finish(tmp_path, dataset):
    txns, _ = dataset
    d = str(tmp_path / "ck")
    full = _port_mine(txns, algorithm="optimized_vfpc", checkpoint_dir=d)
    res = _port_mine(txns, algorithm="optimized_vfpc", checkpoint_dir=d)
    assert res.itemsets() == full.itemsets()
    assert res.n_phases <= 1 and res.dispatches <= 1


def test_retry_recovers_injected_failure():
    rng = np.random.default_rng(7)
    txns = [sorted(set(rng.integers(0, 24, rng.integers(2, 9)).tolist()))
            for _ in range(150)]
    oracle = sequential_apriori(txns, 0.2)
    calls = {"n": 0}

    def fail_once(event, k):
        if event == "count_dispatch":
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("injected shard failure")

    res = mine(txns, n_items=24, min_sup=0.2, count_hook=fail_once,
               device="cpu")
    assert res.retries == 1
    assert res.itemsets() == oracle

    def always_fail(event, k):
        if event == "count_dispatch":
            raise RuntimeError("dead shard")

    with pytest.raises(RuntimeError, match="dead shard"):
        mine(txns, n_items=24, min_sup=0.2, count_hook=always_fail,
             max_retries=1, device="cpu")


def test_straggler_redispatch_keeps_result(dataset):
    txns, oracle = dataset
    res = _port_mine(txns, algorithm="spc", spec_factor=0.0)
    assert res.straggler_events > 0
    assert res.itemsets() == oracle


# -- devices ---------------------------------------------------------------------

def test_default_device_raises_without_a_card(monkeypatch, dataset):
    """The default device is the card; with none the port raises instead of
    running on the CPU."""
    txns, _ = dataset
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MapReduceRuntime()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mine(txns, n_items=N_ITEMS, min_sup=MIN_SUP)
    with pytest.raises(ValueError, match="unsupported device"):
        MapReduceRuntime(device="meta")
    with pytest.raises(ValueError, match="unknown impl"):
        MapReduceRuntime(impl="pallas", device="cpu")
    assert MapReduceRuntime(impl="auto", device="cpu").impl == "vertical"


# -- cost model and roofline -------------------------------------------------------

def test_costmodel_keys_and_cache_are_the_ports_own():
    assert device_key("cpu") == "cpu:cpu"
    assert device_key(torch.device("cpu")) == "cpu:cpu"
    assert os.path.basename(cache_dir()) == "repro_torch"
    assert roofline.COUNT_PEAKS["cuda"] == {"int8_ops": 1979e12,
                                            "mem_bw": 3.35e12}


def test_time_once_is_best_of_reps_after_a_warm_up():
    clock = FakeClock()
    costs = iter([5.0, 0.3, 0.1, 0.2])      # the warm-up call is not timed

    def fn():
        clock.advance(next(costs))

    assert time_once(fn, reps=3, clock=clock) == pytest.approx(0.1)


@pytest.mark.parametrize("family", ["matmul", "vertical", "horizontal"])
def test_roofline_terms_match_reference(family):
    for c, t, w, b in [(1, 1, 1, 0.0), (4096, 10000, 6, 1024.0)]:
        assert roofline.count_job_ops(c, t, w, b) == \
            ref_roofline.count_job_ops(c, t, w, b)
    kw = dict(C=40960, T=200000, W=6, kmax=3, seconds=0.01)
    assert roofline.count_kernel_roofline(family, backend="cpu", **kw) == \
        ref_roofline.count_kernel_roofline(family, backend="cpu", **kw)


def test_controller_decisions_match_reference():
    """Fed the same observations, the port's controller decides as the
    reference's does (both keyed cpu:cpu, neither persisting)."""
    port = CostController(CostModel(persist=False), device="cpu")
    ref = ref_costmodel.CostController(ref_model.CostModel(persist=False),
                                       backend="cpu")
    for c in (port, ref):
        c.set_count_context(n_txns=20000, n_words=6, impl="vertical")
    assert port.choose_width(None, None) is None
    for n, s in [(192, 0.004), (1891, 0.006), (37820, 0.05), (700, 0.005)]:
        port.observe_count(n, s)
        ref.observe_count(n, s)
    hist = [(192, 62, 0.004), (39711, 404, 0.056)]
    got = port.choose_width(PhaseStats(*hist[1]), PhaseStats(*hist[0]))
    want = ref.choose_width(RefPhaseStats(*hist[1]), RefPhaseStats(*hist[0]))
    assert got == want and got is not None
    for est in (10, 1000, 100000):
        assert port.should_speculate(est) == ref.should_speculate(est)
    # the mesh decisions (DESIGN.md §11), in the per-shard basis of a split
    mark = len(port.decisions), len(ref.decisions)
    loads = [[100, 100], [100, 180, 90, 95], [5000, 10, 10, 10]]
    for c in (port, ref):
        c.set_count_context(n_txns=20000, n_words=6, impl="vertical",
                            n_data_shards=4, n_cand_shards=2)
        assert c.choose_mesh(1000, n_devices=1) is None
        assert not c.should_rebalance([7], est_candidates=10)
    for step in range(2):
        for est in (10, 1891, 37820, 10 ** 6):
            for current in (None, (8, 1), (4, 2), (1, 8)):
                got = port.choose_mesh(est, n_devices=8, current=current)
                assert got == ref.choose_mesh(est, n_devices=8,
                                              current=current)
        for shard_loads in loads:
            for est in (256, 40960):
                got = port.should_rebalance(shard_loads, est_candidates=est)
                assert got == ref.should_rebalance(shard_loads,
                                                   est_candidates=est)
        # then with a measured re-scatter penalty and re-pack cost
        for c in (port, ref):
            c.observe_repartition(20000, 6, 0.004)
            c.observe_repartition(40000, 6, 0.009)
            c.observe_rebalance(20000, 0.0002)
            c.observe_rebalance(40000, 0.0005)
    assert port.predict_repartition(30000, 6) == \
        ref.predict_repartition(30000, 6)
    port.observe_count(5000, 0.01)
    ref.observe_count(5000, 0.01)
    rows = port.decision_rows(mark[0])
    assert rows == ref.decision_rows(mark[1])
    assert {r["site"] for r in rows} == {"mesh_split", "rebalance"}
    assert rows[-1]["site"] == "rebalance"
    assert [r["measured"] for r in rows if r["site"] == "mesh_split"][-1] \
        == 0.01


# -- command line and import isolation ---------------------------------------------

def test_cli_matches_reference_cli(tmp_path, monkeypatch):
    from repro.launch import mine as ref_cli
    from repro_torch.launch import mine as port_cli
    common = ["--dataset", "mushroom", "--scale", "0.05", "--min-sup",
              "0.35", "--impl", "vertical"]
    out = {}
    for name in ("reference", "port"):
        j, tr, m = (str(tmp_path / f"{name}.{ext}")
                    for ext in ("json", "trace.json", "metrics.json"))
        argv = common + ["--json-out", j, "--trace-out", tr,
                         "--metrics-out", m]
        if name == "port":
            port_cli.main(argv + ["--device", "cpu"])
        else:
            monkeypatch.setattr(sys, "argv", ["repro.launch.mine", *argv])
            ref_cli.main()
        with open(j) as f:
            out[name] = json.load(f)
        with open(m) as f:
            validate_snapshot(json.load(f))
        with open(tr) as f:
            names = {e["name"] for e in json.load(f)["traceEvents"]}
        assert {"mine.run", "mine.scatter", "mine.phase",
                "mine.count"} <= names
    assert out["port"]["levels"] == out["reference"]["levels"]
    assert out["port"]["dispatches"] == out["reference"]["dispatches"]
    assert out["port"].keys() == out["reference"].keys()


def _run(code, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import importlib.util, sys\n"
        "sys.path.insert(0, 'src')\n"
        "import repro_torch, repro_torch.launch.mine, repro_torch.kernels\n"
        "import repro_torch.core.rules, repro_torch.serving\n"
        "import repro_torch.stream, repro_torch.launch.serve_rules\n"
        "import repro_torch.launch.stream, repro_torch.kernels.autotune\n"
        "import repro_torch.launch.mesh, repro_torch.launch.cliopts\n"
        "import repro_torch.probes.b1_wgmma\n"
        "import repro_torch.probes.store_floor\n"
        "import repro_torch.configs, repro_torch.models\n"
        "import repro_torch.models.moe, repro_torch.models.ssm\n"
        "import repro_torch.models.encdec, repro_torch.probes.decode_ops\n"
        "import repro_torch.serving.engine, repro_torch.launch.serve\n"
        "spec = importlib.util.spec_from_file_location('cs', 'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    """No card, or no repository around it: exit non-zero, print no
    result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    smoke = os.path.join(ROOT, "chip_smoke.py")
    proc = subprocess.run([sys.executable, smoke], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes(open(smoke, "rb").read())
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
