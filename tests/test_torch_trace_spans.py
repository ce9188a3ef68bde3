"""The port's spans inside candidate generation, the counting job's wait,
the cost model's store write, serving's dispatch and the open-loop server's
queue: where each opens, what it carries, and that tracing changes no
result.  Everything runs on the CPU through the kernels' plain versions."""

import numpy as np
import pytest

from repro_torch.core.drivers import mine
from repro_torch.core.rules import generate_ruleset
from repro_torch.costmodel import CostController, CostModel
from repro_torch.costmodel.model import SAVE_INTERVAL_S
from repro_torch.data.generator import mushroom_like
from repro_torch.obs.clock import FakeClock
from repro_torch.obs.trace import NULL_TRACER, Tracer, use_tracer
from repro_torch.serving import OpenLoopServer, RuleServeEngine, RuleStore

MIN_SUP = 0.3


@pytest.fixture(autouse=True)
def _store(tmp_path, monkeypatch):
    """Every cost-model write of these tests lands in ``tmp_path``."""
    path = tmp_path / "costmodel.json"
    monkeypatch.setenv("REPRO_TORCH_COSTMODEL_CACHE", str(path))
    return path


@pytest.fixture(scope="module")
def txns():
    rows, n_items = mushroom_like(n_txns=400, seed=3)
    return rows, n_items


def _mine(txns, **kw):
    rows, n_items = txns
    return mine(rows, n_items=n_items, min_sup=MIN_SUP,
                algorithm="optimized_vfpc", device="cpu",
                controller=CostController(CostModel(persist=False)), **kw)


def _inside(span, outer):
    return outer.t0 <= span.t0 and span.t1 <= outer.t1


def _parents(tr, name, parent):
    """Each ``name`` span with the ``parent`` spans that hold it."""
    outers = [s for s in tr.spans if s.name == parent]
    return [(s, [o for o in outers if _inside(s, o)])
            for s in tr.spans if s.name == name]


def _levels(res):
    return {k: (m.tolist(), c.tolist()) for k, (m, c) in res.levels.items()}


def test_mine_join_and_prune_nest_in_gen_and_the_wait_in_count(txns):
    tr = Tracer()
    with use_tracer(tr):
        res = _mine(txns)
    names = [s.name for s in tr.spans]
    assert names.count("mine.join") >= 2 and "mine.prune" in names
    for name in ("mine.join", "mine.prune"):
        for s, outer in _parents(tr, name, "mine.gen"):
            assert len(outer) == 1, name
            assert {"k", "n_in", "n_out"} <= set(s.attrs)
            assert s.attrs["n_out"] <= max(s.attrs["n_in"], 1) ** 2
    for s in tr.spans:
        if s.name == "mine.prune":
            assert s.attrs["n_out"] <= s.attrs["n_in"]
    waits = _parents(tr, "mine.count_wait", "mine.count")
    assert len(waits) == res.dispatches
    for s, outer in waits:
        assert len(outer) == 1
        assert 0.0 <= s.attrs["sync_s"] <= s.duration
    # the roofline attributes are gone from the counting spans
    for s in tr.spans:
        if s.name == "mine.count":
            assert not any(a.startswith("roofline") for a in s.attrs)


def test_spans_use_the_tracers_clock_on_the_main_track(txns):
    clock = FakeClock(5.0)
    tr = Tracer(clock=clock)
    with use_tracer(tr):
        _mine(txns)
    new = [s for s in tr.spans
           if s.name in ("mine.join", "mine.prune", "mine.count_wait")]
    assert new and all(s.tid == "main" for s in new)
    assert all(s.t0 == s.t1 == 5.0 for s in new)


def test_the_speculative_join_resolves_in_a_join_span(txns):
    """A phase whose first join was speculated resolves it by pair filtering
    in a ``mine.join`` span marked ``spec``, then prunes in ``mine.prune``."""
    from repro_torch.core.candidates import (apriori_gen, prune,
                                             speculative_join)
    res = _mine(txns)
    l2 = res.levels[2][0]
    spec = speculative_join(l2, 2)
    keep = np.ones(l2.shape[0], bool)
    keep[::3] = False
    tr = Tracer()
    with use_tracer(tr):
        got = prune(spec.resolve(keep), l2[keep], 2)
    assert got.tolist() == apriori_gen(l2[keep], 2).tolist()
    (j,) = [s for s in tr.spans if s.name == "mine.join"]
    assert j.attrs == {"k": 3, "spec": True, "on_device": False,
                       "n_in": int(keep.sum()), "n_out": j.attrs["n_out"]}
    (p,) = [s for s in tr.spans if s.name == "mine.prune"]
    assert p.attrs["n_in"] == j.attrs["n_out"]
    assert p.attrs["n_out"] == got.shape[0]


def test_costmodel_save_spans_only_when_persisting(_store):
    """Two observations within ``SAVE_INTERVAL_S`` write once, in a span on
    ``main``, where the model persists; ``flush`` writes the second."""
    for persist, want in ((True, 1), (False, 0)):
        model = CostModel(persist=persist, clock=FakeClock(0.0))
        tr = Tracer()
        with use_tracer(tr):
            model.observe("cpu:count:x", 100.0, 0.01)
            model.observe("cpu:count:y", 200.0, 0.02)
        saves = [s for s in tr.spans if s.name == "costmodel.save"]
        assert len(saves) == want
        assert [s.attrs["key"] for s in saves] == ["cpu:count:x"][:want]
        with use_tracer(tr):
            model.flush()
        saves = [s for s in tr.spans if s.name == "costmodel.save"]
        assert len(saves) == 2 * want
        assert all(s.tid == "main" and s.t1 is not None for s in saves)
    assert _store.exists()


def test_a_mine_writes_the_store_in_costmodel_save_spans(txns):
    rows, n_items = txns
    model = CostModel(persist=True)
    tr = Tracer()
    with use_tracer(tr):
        # no straggler re-dispatch, which a loaded host's timing can set
        # off and which observes nothing
        mine(rows, n_items=n_items, min_sup=MIN_SUP,
             algorithm="optimized_vfpc", device="cpu",
             controller=CostController(model), spec_factor=float("inf"))
    (run,) = [s for s in tr.spans if s.name == "mine.run"]
    saves = [s for s in tr.spans if s.name == "costmodel.save"]
    assert 1 <= len(saves) <= 1 + run.duration / SAVE_INTERVAL_S
    assert all(_inside(s, run) for s in saves)
    model.flush()
    disk = CostModel(persist=True)
    assert disk._fits.keys() == model._fits.keys()
    assert all(disk.n_samples(k) == model.n_samples(k) for k in model._fits)


@pytest.fixture(scope="module")
def rules(txns):
    rows, n_items = txns
    res = mine(rows, n_items=n_items, min_sup=MIN_SUP,
               algorithm="optimized_vfpc", device="cpu",
               controller=CostController(CostModel(persist=False)))
    half = [r[:-1] for r in rows[:48]]
    return generate_ruleset(res, min_confidence=0.6, device="cpu"), half


def _engine(ruleset):
    return RuleServeEngine(ruleset, impl="jnp", device="cpu",
                           controller=CostController(CostModel(persist=False)))


def _key(results):
    return [[[(r.consequent, r.confidence, r.lift, r.score) for r in q]
             for q in b] for b in results]


def test_engine_dispatch_holds_pack_score_fetch_and_decode(rules):
    ruleset, baskets = rules
    eng = _engine(ruleset)
    tr = Tracer()
    batches = [baskets[:5], baskets[5:16], baskets[16:19]]
    with use_tracer(tr):
        eng.serve(batches)
    dispatches = [s for s in tr.spans if s.name == "serve.engine_dispatch"]
    assert dispatches
    for name, per in (("serve.pack", 1), ("serve.score", 1),
                      ("serve.fetch", 1), ("serve.decode", 1)):
        inner = _parents(tr, name, "serve.engine_dispatch")
        assert len(inner) == per * len(dispatches), name
        assert all(len(outer) == 1 for _, outer in inner), name
    for d in dispatches:
        inner = [s for s in tr.spans if s.name in
                 ("serve.pack", "serve.score", "serve.fetch", "serve.decode")
                 and _inside(s, d)]
        assert sum(s.duration for s in inner) <= d.duration
        q = d.attrs["n_queries"]
        (score,) = [s for s in inner if s.name == "serve.score"]
        assert score.attrs["family"] == "jnp"
        assert score.attrs["q_padded"] >= q
        (dec,) = [s for s in inner if s.name == "serve.decode"]
        assert dec.attrs["n_queries"] == q


def _server(ruleset, clock):
    eng = _engine(ruleset)
    return OpenLoopServer(eng, batch=4, max_wait_ms=5.0, cache_size=64,
                          clock=clock,
                          dispatch_cost_fn=lambda n, work: 1e-3 * n)


def _offer(srv, baskets, clock):
    out = []
    for i, b in enumerate(baskets + baskets[:6]):
        clock.advance(1e-3)
        out.append(srv.submit(b, 1e-3 * i, tenant="default"))
    clock.advance(1e-3)
    srv.flush()
    return out


def test_open_loop_server_spans_every_submit_and_each_batchs_waits(rules):
    ruleset, baskets = rules
    clock = FakeClock()
    srv = _server(RuleStore(tenants={"default": ruleset}, device="cpu"),
                  clock)
    tr = Tracer()
    with use_tracer(tr):
        outs = _offer(srv, baskets[:20], clock)
    submits = [s for s in tr.spans if s.name == "serve.submit"]
    assert len(submits) == len(outs)
    assert {s.attrs["outcome"] for s in submits} <= {
        "queued", "served", "cached", "shed"}
    assert {"cached", "served", "queued"} <= {s.attrs["outcome"]
                                              for s in submits}
    batches = [s for s in tr.spans if s.name == "serve.batch"]
    assert len(batches) == srv.dispatches
    served = sum(1 for o in outs if o.outcome == "served")
    assert sum(s.attrs["n_queries"] for s in batches) == served
    waits = [w for s in batches for w in s.attrs["wait_s"]]
    assert len(waits) == served and all(w >= 0 for w in waits)
    assert any(w > 0 for w in waits)
    for s in batches:
        assert len(s.attrs["wait_s"]) == s.attrs["n_queries"]
    assert all(s.tid == "main" for s in submits + batches)


def test_results_equal_with_and_without_a_tracer(txns, rules):
    plain = _mine(txns)
    with use_tracer(Tracer()):
        traced = _mine(txns)
    assert _levels(traced) == _levels(plain)

    ruleset, baskets = rules
    batches = [baskets[:7], baskets[7:30]]
    with use_tracer(NULL_TRACER):
        want = _key(_engine(ruleset).serve(batches)[0])
    with use_tracer(Tracer()):
        got = _key(_engine(ruleset).serve(batches)[0])
    assert got == want

    runs = []
    for tracer in (NULL_TRACER, Tracer()):
        clock = FakeClock()
        srv = _server(RuleStore(tenants={"default": ruleset}, device="cpu"),
                      clock)
        with use_tracer(tracer):
            outs = _offer(srv, baskets[:20], clock)
        runs.append([(o.outcome, o.latency_s, o.results) for o in outs])
    assert runs[0] == runs[1]
