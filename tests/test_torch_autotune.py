"""The port's autotuner (``repro_torch.kernels.autotune``) against the JAX
package's, and the port's ``impl="auto"`` wiring in mining, streaming and
serving; with the port's metrics-validation and report CLIs.

The plan tests mirror ``tests/test_autotune_plan.py``: scripted per-family
wall times go into ``time_once`` (and a fake ``_candidate_runner``), so the
joint sweep is checked deterministically.  The port times only on a card,
so these tests let the CPU device time (``_can_time``); the wiring tests
then run the kernels' plain versions, and whichever family the scripted
plan picks, the outputs must equal every fixed family's.  The real sweep on
the card is ``test_plan_real_sweep_on_the_card`` in ``test_torch_gpu.py``.
"""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

import repro.kernels.autotune as ref_at
import repro_torch.costmodel.model as cm
import repro_torch.kernels.autotune as at
import repro_torch.kernels.delta_count as dc
from repro_torch.core import MapReduceRuntime, generate_ruleset, mine
from repro_torch.costmodel import CostController, CostModel, device_key
from repro_torch.kernels import _build
from repro_torch.serving import RuleServeEngine, RuleStore
from repro_torch.stream import StreamMiner, levels_equal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ITEMS, MIN_SUP = 16, 0.25
NEVER_STALE = 1e9     # staleness factor that never fires: paths stay exact
ALL_FAMILIES = [f for fams in at.PLAN_FAMILIES.values() for f in fams]


def _fresh(monkeypatch, tmp_path, timing=True):
    """A fresh autotune cache and cost model; ``timing`` lets the CPU
    device time, as a card would."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE", raising=False)
    monkeypatch.setattr(at, "_memory_cache", {})
    # the plan sweep prices families off the shared cost model; a
    # calibrated per-machine cache could prune scripted families
    monkeypatch.setenv("REPRO_TORCH_COSTMODEL_CACHE", str(tmp_path / "cm.json"))
    monkeypatch.setattr(cm, "_default", None)
    if timing:
        monkeypatch.setattr(at, "_can_time", lambda device: True)


def _fresh_reference(monkeypatch, tmp_path):
    import repro.costmodel.model as ref_cm
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "ref_at.json"))
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    monkeypatch.setattr(ref_at, "_memory_cache", {})
    monkeypatch.setenv("REPRO_COSTMODEL_CACHE", str(tmp_path / "ref_cm.json"))
    monkeypatch.setattr(ref_cm, "_default", None)


def _script_times(monkeypatch, times_us, module=at):
    """Make every family run at its scripted time (µs), configs tie."""
    def fake_runner(impl, C, T, W, kmax, **kw):
        return lambda cfg, impl=impl: impl

    def fake_time_once(marker):
        return times_us[marker] * 1e-6
    monkeypatch.setattr(module, "_candidate_runner", fake_runner)
    monkeypatch.setattr(module, "time_once", fake_time_once)


def _winner_times(winner: str) -> dict:
    """Scripted times for every family of every kind, ``winner`` (a family
    key) fastest of its kind."""
    return {f: (1.0 if f == winner else 100.0 + i)
            for i, f in enumerate(ALL_FAMILIES)}


def _no_timing(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("nothing may be timed here")
    monkeypatch.setattr(at, "time_once", boom)
    monkeypatch.setattr(at, "_candidate_runner", boom)


# -- the plan, as the reference's tests hold it ----------------------------------

def test_plan_disabled_returns_none(monkeypatch, tmp_path):
    _fresh(monkeypatch, tmp_path)
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "0")
    _no_timing(monkeypatch)
    assert at.tuned_plan("count", C=256, T=8124, W=4) is None


def test_plan_unknown_kind_raises(monkeypatch, tmp_path):
    _fresh(monkeypatch, tmp_path)
    with pytest.raises(ValueError):
        at.tuned_plan("frobnicate", C=1, T=1)


def test_plan_baseline_beats_tuned_vertical_own_goal(monkeypatch, tmp_path):
    """The reference's recorded C=256 own-goal: vertical 107.7 ms vs jnp
    2.5 ms — the joint sweep must pick jnp."""
    _fresh(monkeypatch, tmp_path)
    _script_times(monkeypatch, {
        "jnp": 2509.0, "matmul": 6000.0,
        "vertical": 107708.7, "vertical_matmul": 15000.0})
    plan = at.tuned_plan("count", C=256, T=8124, W=4, kmax=23, device="cpu")
    assert plan["impl"] == "jnp" and plan["family"] == "jnp"
    assert "jnp" in plan["timed_us"]            # baseline always cross-checked
    assert plan["timed_us"][plan["family"]] == min(plan["timed_us"].values())
    assert set(plan) == {"impl", "family", "blocks", "timed_us"}


@pytest.mark.parametrize("kind,times,want", [
    ("count", {"jnp": 90.0, "matmul": 20.0, "vertical": 400.0,
               "vertical_matmul": 100.0}, "matmul"),
    ("count", {"jnp": 90.0, "matmul": 120.0, "vertical": 40.0,
               "vertical_matmul": 100.0}, "vertical"),
    ("delta", {"delta_jnp": 50.0, "delta_matmul": 10.0}, "matmul"),
    ("delta", {"delta_jnp": 5.0, "delta_matmul": 10.0}, "jnp"),
    ("rules", {"rules_jnp": 30.0, "rules_matmul": 5.0}, "matmul"),
    ("rules", {"rules_jnp": 3.0, "rules_matmul": 5.0}, "jnp"),
])
def test_plan_picks_fastest_family(monkeypatch, tmp_path, kind, times, want):
    _fresh(monkeypatch, tmp_path)
    _script_times(monkeypatch, times)
    plan = at.tuned_plan(kind, C=128, T=1024, W=2, device="cpu")
    assert plan["impl"] == want
    assert set(plan["timed_us"]) == set(times)
    assert plan["timed_us"] == pytest.approx(times)


@pytest.mark.parametrize("kind", sorted(at.PLAN_FAMILIES))
def test_plan_equals_reference_on_the_same_timings(monkeypatch, tmp_path,
                                                   kind):
    """Fed the same scripted times, the port's plan names the winner and
    the timings the reference's plan names (the reference on its CPU
    backend, which has the port's families: no Pallas)."""
    _fresh(monkeypatch, tmp_path)
    _fresh_reference(monkeypatch, tmp_path)
    rng = np.random.default_rng(len(kind))
    times = {f: float(t) for f, t in zip(
        at.PLAN_FAMILIES[kind],
        rng.permutation(len(at.PLAN_FAMILIES[kind])) * 10.0 + 7.0)}
    _script_times(monkeypatch, times)
    _script_times(monkeypatch, times, module=ref_at)
    got = at.tuned_plan(kind, C=300, T=5000, W=3, kmax=5, device="cpu")
    want = ref_at.tuned_plan(kind, C=300, T=5000, W=3, kmax=5, backend="cpu")
    for field in ("impl", "family", "timed_us"):
        assert got[field] == want[field], field
    assert got["blocks"] == {}
    # one key each, the same shape bucket behind the device identity
    port_key = next(iter(json.load(open(tmp_path / "at.json"))))
    ref_keys = [k for k in json.load(open(tmp_path / "ref_at.json"))
                if "/plan/" in k]
    assert port_key.split("/", 1)[1] == ref_keys[0].split("/", 1)[1]


def test_plan_cached_no_resweep(monkeypatch, tmp_path):
    _fresh(monkeypatch, tmp_path)
    _script_times(monkeypatch, {"delta_jnp": 5.0, "delta_matmul": 50.0})
    first = at.tuned_plan("delta", C=64, T=512, W=1, device="cpu")
    assert first["impl"] == "jnp"
    disk = json.load(open(tmp_path / "at.json"))
    plan_keys = [k for k in disk if "/plan/delta/" in k]
    assert len(plan_keys) == 1 and plan_keys[0].startswith(device_key("cpu"))

    def boom(*a, **kw):
        raise AssertionError("cached plan must not re-sweep")
    monkeypatch.setattr(at, "time_once", boom)
    again = at.tuned_plan("delta", C=64, T=512, W=1, device="cpu")
    assert again["impl"] == first["impl"]
    # and a fresh process (cold memory cache) reads the disk entry
    monkeypatch.setattr(at, "_memory_cache", {})
    cold = at.tuned_plan("delta", C=64, T=512, W=1, device="cpu")
    assert cold == first


def test_cache_lives_under_the_ports_own_directory(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert at.cache_path() == str(tmp_path / ".cache" / "repro_torch" /
                                  "autotune.json")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "x.json"))
    assert at.cache_path() == str(tmp_path / "x.json")
    # the reference's variables steer only the reference's store
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "ref.json"))
    assert at.cache_path() == str(tmp_path / "x.json")


@pytest.mark.parametrize("error", [ValueError, TypeError])
def test_plan_survives_family_shape_errors(monkeypatch, tmp_path, error):
    """A family whose wrapper refuses the shape is skipped, not fatal."""
    _fresh(monkeypatch, tmp_path)

    def fake_runner(impl, C, T, W, kmax, **kw):
        return lambda cfg, impl=impl: impl

    def flaky(marker):
        if marker != "delta_matmul":
            raise error("txns must have 2 dims")
        return 1e-3
    monkeypatch.setattr(at, "_candidate_runner", fake_runner)
    monkeypatch.setattr(at, "time_once", flaky)
    plan = at.tuned_plan("delta", C=64, T=512, W=1, device="cpu")
    assert plan["family"] == "delta_matmul"
    assert set(plan["timed_us"]) == {"delta_matmul"}


def test_plan_falls_back_to_baseline_when_every_family_refuses(monkeypatch,
                                                               tmp_path):
    _fresh(monkeypatch, tmp_path)

    def refuse(marker):
        raise ValueError("shape")
    monkeypatch.setattr(at, "_candidate_runner",
                        lambda impl, *a, **kw: lambda cfg, impl=impl: impl)
    monkeypatch.setattr(at, "time_once", refuse)
    plan = at.tuned_plan("rules", C=64, T=512, W=1, device="cpu")
    assert plan["family"] == "rules_jnp" and plan["timed_us"] == {}


# -- the port's own rules ----------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(at.PLAN_FAMILIES))
def test_plan_on_the_cpu_is_none_and_untimed(monkeypatch, tmp_path, kind):
    """On the CPU the wrappers run the plain versions, whose times mean
    nothing: no plan, nothing timed, nothing written."""
    _fresh(monkeypatch, tmp_path, timing=False)
    _no_timing(monkeypatch)
    assert at.tuned_plan(kind, C=256, T=4096, W=2, device="cpu") is None
    assert not (tmp_path / "at.json").exists()
    # and the wiring takes its static fallbacks
    rt = MapReduceRuntime(impl="auto", device="cpu")
    rt.scatter_db(np.ones((10, 1), np.uint32), n_items=8)
    assert rt.impl == "vertical"
    assert dc.resolve_delta_impl("auto", C=64, T=32, W=1,
                                 device="cpu") == "jnp"


def _failing_build(monkeypatch, tmp_path):
    """The real build path with an ``nvcc`` that fails: _build.library
    compiles into an empty directory and raises."""
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    return lambda: _build.library("counting")


def _failing_launch():
    raise RuntimeError("support_count: CUDA launch failed with "
                       "cudaError_t 700")


@pytest.mark.parametrize("failure", ["build", "launch"])
@pytest.mark.parametrize("kind", sorted(at.PLAN_FAMILIES))
def test_build_and_launch_errors_reach_the_caller(monkeypatch, tmp_path,
                                                  failure, kind):
    """The sweep skips only the wrappers' shape errors: a failed build or
    launch must not read as "the other family won"."""
    _fresh(monkeypatch, tmp_path)
    fail = (_failing_build(monkeypatch, tmp_path) if failure == "build"
            else _failing_launch)
    loser = at.PLAN_FAMILIES[kind][-1]

    def runner(impl, C, T, W, kmax, **kw):
        return lambda cfg, impl=impl: fail if impl == loser else impl

    def time_it(fn):
        return fn() if callable(fn) else 1e-6
    monkeypatch.setattr(at, "_candidate_runner", runner)
    monkeypatch.setattr(at, "time_once", time_it)
    match = "nvcc failed" if failure == "build" else "CUDA launch failed"
    with pytest.raises(RuntimeError, match=match):
        at.tuned_plan(kind, C=64, T=512, W=1, device="cpu")
    assert not (tmp_path / "at.json").exists()
    if kind == "count":     # through the runtime and mine() to their caller
        with pytest.raises(RuntimeError, match=match):
            mine(_txns(0), n_items=N_ITEMS, min_sup=MIN_SUP,
                 runtime=MapReduceRuntime(impl="auto", device="cpu"))


def test_tuned_blocks_returns_empty_untimed(monkeypatch, tmp_path):
    """No port wrapper takes a block size: every family gets ``{}`` and
    nothing is timed, on a timing device, on the CPU and when disabled."""
    assert at.CONFIGS == {}
    _fresh(monkeypatch, tmp_path)
    _no_timing(monkeypatch)
    for fam in ALL_FAMILIES:
        assert at.tuned_blocks(fam, C=300, T=200, W=1, kmax=3,
                               device="cpu") == {}
    monkeypatch.setattr(at, "_can_time", lambda device: False)
    assert at.tuned_blocks("vertical", C=300, T=200, device="cpu") == {}
    assert not (tmp_path / "at.json").exists()


def test_autotuner_caches_in_process_and_on_disk(tmp_path, monkeypatch):
    """The reference's block-cache test, on a family given configs: the
    sweep keeps its key format and caches in memory and on disk."""
    _fresh(monkeypatch, tmp_path)
    configs = [{"tile": 64}, {"tile": 128}, {"tile": 256}]
    monkeypatch.setitem(at.CONFIGS, "vertical", configs)
    monkeypatch.setattr(at, "_candidate_runner",
                        lambda impl, *a, **kw: lambda cfg: cfg["tile"])
    monkeypatch.setattr(at, "time_once", lambda tile: abs(tile - 128) + 1.0)
    cfg = at.tuned_blocks("vertical", C=300, T=200, W=1, kmax=3,
                          device="cpu")
    assert cfg == {"tile": 128}
    disk = json.load(open(tmp_path / "at.json"))
    assert list(disk) == [f"{device_key('cpu')}/vertical/C512/T256/W1/k3"]
    assert list(disk.values())[0] == cfg
    # second call: in-process hit, nothing timed
    monkeypatch.setattr(at, "time_once", None)
    assert at.tuned_blocks("vertical", C=300, T=200, W=1, kmax=3,
                           device="cpu") == cfg
    # REPRO_TORCH_AUTOTUNE=0 returns the static default untimed
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "0")
    assert at.tuned_blocks("vertical", C=9999, T=9999, device="cpu") == {}


# -- the wiring: mining ---------------------------------------------------------------

def _txns(seed, n=160, n_items=N_ITEMS):
    """Patterned random baskets (the ``test_drivers.py`` generator)."""
    rng = np.random.default_rng(seed)
    base = rng.random((4, n_items)) < 0.45
    out = []
    for _ in range(n):
        row = np.where(rng.random(n_items) < 0.85, base[rng.integers(4)],
                       rng.random(n_items) < 0.15)
        out.append(np.nonzero(row)[0].tolist() or [0])
    return out


def test_runtime_auto_impl_follows_plan(monkeypatch, tmp_path):
    """MapReduceRuntime(impl='auto') adopts the plan winner in scatter_db."""
    from repro_torch.core.mapreduce import IMPLS
    _fresh(monkeypatch, tmp_path)
    _script_times(monkeypatch, {
        "jnp": 500.0, "matmul": 5.0, "vertical": 900.0,
        "vertical_matmul": 700.0})
    rt = MapReduceRuntime(impl="auto", device="cpu")
    assert rt._auto_impl and rt.impl == "vertical"    # static until scatter
    rng = np.random.default_rng(0)
    masks = rng.integers(0, 2**32, (200, 1), dtype=np.uint32)
    rt.scatter_db(masks, n_items=20)
    assert rt.impl == "matmul" and rt.impl in IMPLS
    key = next(iter(json.load(open(tmp_path / "at.json"))))
    # rep_c = min(max(16·20, 256), 4096) = 320 → C512, 200 rows → T256
    assert key == f"{device_key('cpu')}/plan/count/C512/T256/W1/k4"
    # autotune=False pins the static fallback
    rt = MapReduceRuntime(impl="auto", device="cpu", autotune=False)
    rt.scatter_db(masks, n_items=20)
    assert rt.impl == "vertical"


@pytest.mark.parametrize("winner", at.PLAN_FAMILIES["count"])
def test_mine_auto_equals_every_fixed_family(monkeypatch, tmp_path, winner):
    _fresh(monkeypatch, tmp_path)
    _script_times(monkeypatch, _winner_times(winner))
    txns = _txns(1)
    rt = MapReduceRuntime(impl="auto", device="cpu")
    auto = mine(txns, n_items=N_ITEMS, min_sup=MIN_SUP, runtime=rt)
    assert rt.impl == winner
    for family in at.PLAN_FAMILIES["count"]:
        fixed = mine(txns, n_items=N_ITEMS, min_sup=MIN_SUP,
                     runtime=MapReduceRuntime(impl=family, device="cpu"))
        assert levels_equal(auto.levels, fixed.levels), family
        for k in fixed.levels:
            for a, b in zip(auto.levels[k], fixed.levels[k]):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_driver_repins_count_key_after_auto_scatter(monkeypatch, tmp_path):
    """The controller's count context follows the family the scatter
    adopted, so the run calibrates the winner's fit, not the fallback's."""
    _fresh(monkeypatch, tmp_path)
    _script_times(monkeypatch, _winner_times("matmul"))
    controller = CostController(CostModel(persist=False), device="cpu")
    rt = MapReduceRuntime(impl="auto", device="cpu")
    mine(_txns(2), n_items=N_ITEMS, min_sup=MIN_SUP, runtime=rt,
         controller=controller)
    assert rt.impl == "matmul"
    assert controller.count_key == "cpu:cpu/matmul/count"
    assert controller.model.n_samples("cpu:cpu/matmul/count") > 0
    assert controller.model.n_samples("cpu:cpu/vertical/count") == 0


# -- the wiring: streaming ------------------------------------------------------------

@pytest.mark.parametrize("winner", ["jnp", "matmul"])
def test_delta_count_auto_follows_plan(monkeypatch, tmp_path, winner):
    _fresh(monkeypatch, tmp_path)
    _script_times(monkeypatch, _winner_times(f"delta_{winner}"))
    ran = []
    for fam, fn in list(dc._FAMILIES.items()):
        monkeypatch.setitem(dc._FAMILIES, fam,
                            lambda *a, fam=fam, fn=fn: ran.append(fam)
                            or fn(*a))
    rng = np.random.default_rng(3)
    cands = rng.integers(0, 2**32, (70, 2), dtype=np.uint32) & \
        rng.integers(0, 2**32, (70, 2), dtype=np.uint32)
    added = ~rng.integers(0, 2**32, (21, 2), dtype=np.uint32)
    evicted = ~rng.integers(0, 2**32, (9, 2), dtype=np.uint32)
    got = dc.delta_count(cands, added, evicted, impl="auto", device="cpu")
    assert ran == [winner]
    for family in ("jnp", "matmul"):
        np.testing.assert_array_equal(
            got, dc.delta_count(cands, added, evicted, impl=family,
                                device="cpu"))
    key = next(k for k in json.load(open(tmp_path / "at.json")))
    assert key == f"{device_key('cpu')}/plan/delta/C128/T32/W2/k1"
    # autotune=False takes the static fallback
    ran.clear()
    dc.delta_count(cands, added, evicted, autotune=False, device="cpu")
    assert ran == ["jnp"]


@pytest.mark.parametrize("winner", ["jnp", "matmul"])
def test_stream_miner_auto_equals_every_fixed_family(monkeypatch, tmp_path,
                                                     winner):
    _fresh(monkeypatch, tmp_path)
    _script_times(monkeypatch, _winner_times(f"delta_{winner}"))
    txns = _txns(4, n=400, n_items=12)
    miners = {impl: StreamMiner(12, 0.3, capacity=128, impl=impl,
                                staleness_factor=NEVER_STALE, device="cpu")
              for impl in ("auto", "jnp", "matmul")}
    for m in miners.values():
        m.push(txns[:128])
    for u in range(6):
        batch = txns[128 + 16 * u:144 + 16 * u]
        recs = {impl: m.push(batch) for impl, m in miners.items()}
        for impl in ("jnp", "matmul"):
            assert recs["auto"].path == recs[impl].path
            assert levels_equal(miners["auto"].levels, miners[impl].levels)
    n_delta = sum(1 for r in miners["auto"].updates if r.path == "delta")
    assert n_delta > 0
    assert dict(miners["auto"].delta_families) == {winner: n_delta}
    assert dict(miners["jnp"].delta_families) == {"jnp": n_delta}
    off = StreamMiner(12, 0.3, capacity=128, autotune=False,
                      staleness_factor=NEVER_STALE, device="cpu")
    off.push(txns[:128])
    off.push(txns[128:144])
    assert set(off.delta_families) <= {"jnp"}


# -- the wiring: serving --------------------------------------------------------------

@pytest.fixture(scope="module")
def ruleset():
    res = mine(_txns(5, n=300), n_items=N_ITEMS, min_sup=0.2,
               runtime=MapReduceRuntime(device="cpu", autotune=False))
    return generate_ruleset(res, min_confidence=0.5, device="cpu")


def _baskets(n, seed=6):
    rng = np.random.default_rng(seed)
    return [np.nonzero(rng.random(N_ITEMS) < 0.4)[0].tolist()
            for _ in range(n)]


@pytest.mark.parametrize("winner", ["jnp", "matmul"])
def test_rules_engine_resolves_plan_per_state_and_bucket(monkeypatch,
                                                         tmp_path, ruleset,
                                                         winner):
    _fresh(monkeypatch, tmp_path)
    _script_times(monkeypatch, _winner_times(f"rules_{winner}"))
    assert len(ruleset) > 0
    eng = RuleServeEngine(ruleset, impl="auto", device="cpu")
    assert eng.family == "jnp"                # the CPU's static fallback
    eng.warmup(64)
    state = eng.store.state
    assert state.plans == {8: winner, 16: winner, 32: winner, 64: winner}
    assert eng.family == winner
    keys = sorted(json.load(open(tmp_path / "at.json")))
    R = at._bucket(len(state))
    assert keys == sorted(f"{device_key('cpu')}/plan/rules/C{R}/T{q}/"
                          f"W{state.W}/k1" for q in (8, 16, 32, 64))

    # the serving loop times nothing: every dispatch is a memo lookup
    _no_timing(monkeypatch)
    baskets = _baskets(90)
    batches = [baskets[i:i + 9] for i in range(0, 90, 9)]
    got, _ = eng.serve(batches)
    for family in ("jnp", "matmul"):
        want, _ = RuleServeEngine(ruleset, impl=family,
                                  device="cpu").serve(batches)
        assert got == want, family

    # a swap publishes a new state, resolved again during its warm-up: from
    # the plan cache (same shape buckets) without a sweep ...
    eng.swap_rules(ruleset, warm_to=16)
    assert eng.store.state is not state
    assert eng.store.state.plans == {8: winner, 16: winner}
    # ... or, with a cold cache, by a new sweep; the old state keeps its own
    _fresh(monkeypatch, tmp_path / "cold")
    loser = "matmul" if winner == "jnp" else "jnp"
    _script_times(monkeypatch, _winner_times(f"rules_{loser}"))
    eng.swap_rules(ruleset, warm_to=16)
    assert eng.store.state.plans == {8: loser, 16: loser}
    assert eng.family == loser and state.plans[8] == winner


def test_rules_engine_autotune_off_keeps_the_fallback(monkeypatch, tmp_path,
                                                      ruleset):
    _fresh(monkeypatch, tmp_path)
    _no_timing(monkeypatch)
    eng = RuleServeEngine(ruleset, impl="auto", autotune=False, device="cpu")
    eng.warmup(16)
    assert eng.store.state.plans == {8: "jnp", 16: "jnp"}
    fixed = RuleServeEngine(ruleset, impl="matmul", device="cpu")
    fixed.warmup(16)
    assert fixed.family == "matmul" and fixed.store.state.plans == {}


def test_multi_tenant_auto_equals_fixed(monkeypatch, tmp_path, ruleset):
    _fresh(monkeypatch, tmp_path)
    _script_times(monkeypatch, _winner_times("rules_matmul"))
    res = mine(_txns(7, n=300), n_items=N_ITEMS, min_sup=0.2,
               runtime=MapReduceRuntime(device="cpu", autotune=False))
    tenants = {"a": ruleset,
               "b": generate_ruleset(res, min_confidence=0.5, device="cpu")}
    pairs = [("ab"[i % 2], b) for i, b in enumerate(_baskets(40, seed=8))]
    out = {}
    for impl in ("auto", "jnp", "matmul"):
        eng = RuleServeEngine(RuleStore(tenants=tenants, device="cpu"),
                              impl=impl, device="cpu")
        eng.warmup(64)
        out[impl], _ = eng.serve([pairs[:20], pairs[20:]])
    assert out["auto"] == out["jnp"] == out["matmul"]


# -- the CLIs: family lines, metrics validation, reports -------------------------------

def _cli(main, argv) -> str:
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    assert not rc
    return buf.getvalue()


@pytest.fixture(scope="module")
def cli_outputs(tmp_path_factory):
    """The port's three CLIs on the CPU, each writing ``--json-out``,
    ``--trace-out`` and ``--metrics-out`` files."""
    from repro_torch.launch import mine as mine_cli
    from repro_torch.launch import serve_rules as serve_cli
    from repro_torch.launch import stream as stream_cli
    from repro_torch.obs.metrics import Registry, set_registry
    tmp = tmp_path_factory.mktemp("cli")
    runs = {
        "mine": (mine_cli.main, ["--dataset", "mushroom", "--scale", "0.05",
                                 "--min-sup", "0.35"]),
        "stream": (stream_cli.main, ["--dataset", "mushroom", "--scale",
                                     "0.06", "--min-sup", "0.4",
                                     "--capacity", "128", "--batch", "16",
                                     "--updates", "4"]),
        "serve_rules": (serve_cli.main, ["--dataset", "mushroom", "--scale",
                                         "0.06", "--min-sup", "0.35",
                                         "--queries", "48", "--batch", "8"]),
    }
    out = {}
    for name, (main, argv) in runs.items():
        files = {ext: str(tmp / f"{name}.{ext}")
                 for ext in ("json", "trace.json", "metrics.json")}
        set_registry(Registry())
        stdout = _cli(main, argv + ["--device", "cpu",
                                    "--json-out", files["json"],
                                    "--trace-out", files["trace.json"],
                                    "--metrics-out", files["metrics.json"]])
        out[name] = (stdout, files)
    set_registry(None)
    return out


def test_clis_print_the_family_auto_resolved_to(cli_outputs):
    lines = {name: [ln for ln in stdout.splitlines()
                    if ln.startswith("auto:")]
             for name, (stdout, _) in cli_outputs.items()}
    # on the CPU there is no plan: the static fallbacks
    assert lines["mine"] == ["auto: counting family vertical"]
    assert lines["serve_rules"] == [
        "auto: scoring family by padded query count "
        "{8: 'jnp', 16: 'jnp', 32: 'jnp', 64: 'jnp', 128: 'jnp'}"]
    assert len(lines["stream"]) == 1
    assert lines["stream"][0].startswith("auto: delta families {'jnp': ")


def test_validate_cli(tmp_path, capsys, cli_outputs):
    from repro_torch.obs.metrics import Registry
    from repro_torch.obs.validate import main as validate_main
    ok = tmp_path / "ok.json"
    ok.write_text(json.dumps(Registry().snapshot()))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema_version": 42}))
    assert validate_main([str(ok)]) == 0
    assert validate_main([str(bad)]) == 1
    assert validate_main([str(ok), str(bad)]) == 1
    out = capsys.readouterr().out
    assert "ok (schema v1" in out and "INVALID" in out
    snapshots = [files["metrics.json"] for _, files in cli_outputs.values()]
    assert validate_main(snapshots) == 0
    out = capsys.readouterr().out
    assert out.count(": ok (schema v1") == 3
    unreadable = tmp_path / "torn.json"
    unreadable.write_text("{")
    assert validate_main([str(unreadable)]) == 1
    assert "UNREADABLE" in capsys.readouterr().out


def test_report_trace_tables(tmp_path, capsys, cli_outputs):
    from repro_torch.launch.report import (load_trace, main, report_trace,
                                           trace_spans)
    from repro_torch.obs.clock import FakeClock
    from repro_torch.obs.trace import Tracer
    clk = FakeClock()
    tr = Tracer(clock=clk)
    with tr.span("mine.run"):
        clk.advance(0.1)
        with tr.span("mine.phase"):
            clk.advance(0.8)
        clk.advance(0.1)
    path = tmp_path / "trace.json"
    tr.export(str(path))
    spans = trace_spans(load_trace(str(path)))
    by_name = {s["name"]: s for s in spans}
    # self time subtracts nested spans on the same track
    assert by_name["mine.run"]["dur"] == pytest.approx(1e6)
    assert by_name["mine.run"]["self_us"] == pytest.approx(0.2e6)
    assert by_name["mine.phase"]["self_us"] == pytest.approx(0.8e6)
    report_trace(str(path), top=5)
    out = capsys.readouterr().out
    assert "slowest spans" in out and "mine.phase" in out
    assert "Per-phase time breakdown" in out
    # the traces the port's CLIs write
    want = {"mine": "mine.scatter", "stream": "stream.update",
            "serve_rules": "serve.engine_dispatch"}
    for name, (_, files) in cli_outputs.items():
        main(["--trace", files["trace.json"], "--top", "3"])
        out = capsys.readouterr().out
        assert "Per-phase time breakdown" in out and want[name] in out


def test_report_decisions_accepts_stream_payload(tmp_path, capsys,
                                                 cli_outputs):
    from repro_torch.launch.report import (load_decisions, main,
                                           report_decisions)
    rows = [{"site": "remine", "key": "k", "chosen": True,
             "predicted": {"remine": 0.5}, "measured": 0.6}]
    stream_shaped = tmp_path / "stream.json"
    stream_shaped.write_text(json.dumps(
        {"updates_per_s": 10.0, "paths": {"delta": 3}, "decisions": rows}))
    assert load_decisions(str(stream_shaped)) == rows
    report_decisions(str(stream_shaped))
    assert "remine" in capsys.readouterr().out
    # a payload without decisions degrades to a hint, not a crash
    legacy = tmp_path / "legacy.json"
    legacy.write_text(json.dumps({"updates_per_s": 10.0}))
    assert load_decisions(str(legacy)) == []
    report_decisions(str(legacy))
    assert "no decision rows" in capsys.readouterr().out
    # the --json-out files of the port's mine, stream and serve_rules
    for name, (_, files) in cli_outputs.items():
        with open(files["json"]) as f:
            payload = json.load(f)
        assert load_decisions(files["json"]) == payload["decisions"]
        main(["--decisions", files["json"]])
        out = capsys.readouterr().out
        assert f"## Cost-model decisions ({files['json']})" in out
        if payload["decisions"]:
            assert f"{len(payload['decisions'])} decisions recorded" in out


def test_report_dryrun_tables(tmp_path, capsys):
    """The third mode: dry-run cells → status, roofline and hillclimb."""
    from repro_torch.launch.report import main
    roof = {"compute_s": 0.01, "memory_s": 2.0, "collective_s": 0.02,
            "dominant": "memory", "model_flops": 1e12, "useful_ratio": 0.5}
    cells = [
        {"arch": "a", "shape": "s", "mesh": "16x16", "ok": True,
         "compile_s": 3, "temp_bytes_per_dev": 2**30,
         "arg_bytes_per_dev": 2**31, "hlo_flops_raw": 2e9,
         "collectives_by_op": {"all-reduce": 2**20}, "roofline": roof},
        {"arch": "b", "shape": "s", "mesh": "16x16", "ok": True,
         "compile_s": 4, "temp_bytes_per_dev": 0, "arg_bytes_per_dev": 0,
         "hlo_flops_raw": 0.0, "collectives_by_op": {},
         "roofline": dict(roof, compute_s=1.0, collective_s=30.0,
                          dominant="collective")},
        {"arch": "c", "shape": "s", "mesh": "16x16", "skipped": True},
    ]
    path = tmp_path / "dryrun.jsonl"
    path.write_text("\n".join(json.dumps(c) for c in cells) + "\n")
    main([str(path)])
    out = capsys.readouterr().out
    assert "2 ok / 1 skipped / 0 failed (3 cells)" in out
    assert "| a | s | 16x16 | ok | 3 | 1.00 | 2.00 | 2.0 | all-reduce:1 |" \
        in out
    assert "SKIP" in out and "**collective**" in out
    assert "hillclimb candidates: worst-fraction=('a', 's', '16x16'), " \
           "most-collective=('b', 's', '16x16')" in out


def test_new_modules_run_as_commands_without_jax(tmp_path):
    """``python -m`` of the two CLIs works, and importing them (and the
    autotuner) loads neither jax nor the JAX package."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    snap = tmp_path / "m.json"
    snap.write_text(json.dumps({"schema_version": 1, "counters": {},
                                "gauges": {}, "histograms": {}}))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.validate", str(snap)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "ok (schema v1" in proc.stdout
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.report", "--decisions",
         str(snap)], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "no decision rows" in proc.stdout
    code = ("import sys\n"
            "import repro_torch.obs.validate, repro_torch.launch.report\n"
            "import repro_torch.kernels.autotune\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')))\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
