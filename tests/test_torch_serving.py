"""The port's rule serving against the JAX package's: engine results, the
multi-tenant arena, live swaps, open-loop admission and the serving CLI.

Both engines get the same RuleSets (the reference's, carried into the port
with ``RuleSet.from_arrays``) and the same queries; recommendations —
consequents, exact float64 confidence and lift, float32 scores — must be
identical.  The port runs on the CPU, through its kernels' plain versions.
"""

import dataclasses
import io
import sys
import threading
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from loadgen import arrivals, constant_cost, make_ruleset, per_query_cost, tenant_mix
from repro.costmodel import CostController as RefController
from repro.costmodel.model import CostModel as RefCostModel
from repro.serving import OpenLoopServer as RefServer
from repro.serving import RuleServeEngine as RefEngine
from repro.serving import RuleStore as RefStore
from repro_torch.core import RuleSet
from repro_torch.costmodel import CostController, CostModel
from repro_torch.obs.clock import FakeClock
from repro_torch.serving import (DEFAULT_TENANT, OpenLoopServer,
                                 RuleServeEngine, RuleStore)

# (seed, n_items, min_confidence): the reference serving tests' rule pool
POOL_SPECS = [(7, 12, 0.6), (11, 9, 0.55), (23, 16, 0.7)]


def port_rules(ref_rules) -> RuleSet:
    return RuleSet.from_arrays(**dataclasses.asdict(ref_rules))


def key(results):
    """Bit-identity projection of nested recommendation lists, comparable
    across the two packages' Recommendation classes."""
    if isinstance(results, list):
        return [key(r) for r in results]
    r = results
    return (r.consequent, r.confidence, r.lift, np.float32(r.score))


@pytest.fixture(scope="module")
def pool():
    return [make_ruleset(seed, n_items=n, min_confidence=c)
            for seed, n, c in POOL_SPECS]


def engines(ref_rules, **kw):
    """(reference engine, port engine on the CPU) over the same rules."""
    port_impl = kw.pop("impl", "auto")
    ref = RefEngine(ref_rules, impl="jnp", autotune=False, **kw)
    if isinstance(ref_rules, RefStore):
        tenants = {t: port_rules(ref_rules.ruleset(t))
                   for t in ref_rules.tenants}
        rules = RuleStore(tenants=tenants, device="cpu")
    else:
        rules = port_rules(ref_rules)
    return ref, RuleServeEngine(rules, impl=port_impl, device="cpu", **kw)


@pytest.mark.parametrize("impl", ["auto", "jnp", "matmul"])
@pytest.mark.parametrize("dedup", [True, False])
def test_single_tenant_equals_reference(pool, impl, dedup):
    rules, baskets = pool[0]
    ref, port = engines(rules, impl=impl, dedup_consequents=dedup)
    for k in (1, 3, len(rules)):
        assert key(port.query(baskets[:40], top_k=k)) == \
            key(ref.query(baskets[:40], top_k=k))


@pytest.mark.parametrize("family", ["jnp", "matmul"])
@pytest.mark.parametrize("n_queries", [1, 5, 9, 65])
def test_dispatch_scores_only_its_queries(pool, monkeypatch, family,
                                          n_queries):
    """A dispatch hands the scorer exactly its Q baskets, no bucket rows,
    and each answer is the one that basket gets when served alone."""
    from repro_torch.serving import rules_engine
    rules, baskets = pool[0]
    port = RuleServeEngine(port_rules(rules), impl=family, device="cpu")
    seen = []
    scorer = rules_engine._SCORERS[family]

    def recording(antes, cons, scores, packed, **kw):
        seen.append(tuple(packed.shape))
        return scorer(antes, cons, scores, packed, **kw)
    monkeypatch.setitem(rules_engine._SCORERS, family, recording)
    got = port.query(baskets[:n_queries], top_k=3)
    assert seen == [(n_queries, port.store.state.W)]
    assert key(got) == [key(port.query([b], top_k=3)[0])
                        for b in baskets[:n_queries]]


def test_ties_in_scores_rank_lowest_index_first(pool):
    """Hazard: scores rounded to one decimal leave many equal scores; the
    port must order them as ``lax.top_k`` does, so a raw rule-level top-k
    (no de-duplication) equals the reference's."""
    rules, baskets = pool[0]
    tied = dataclasses.replace(rules, score=np.round(rules.score, 1)
                               .astype(np.float32))
    assert len(np.unique(tied.score)) < len(tied.score) // 2
    ref, port = engines(tied, dedup_consequents=False)
    assert key(port.query(baskets[:40], top_k=len(tied))) == \
        key(ref.query(baskets[:40], top_k=len(tied)))


@pytest.mark.parametrize("algorithm", ["spc", "optimized_vfpc", "fpc"])
def test_fused_and_per_batch_dispatch_equal_reference(pool, algorithm):
    rules, baskets = pool[0]
    batches = [baskets[i:i + 5] for i in range(0, 40, 5)]
    ref, port = engines(rules, algorithm=algorithm)
    got, records = port.serve(batches)
    want, ref_records = ref.serve(batches)
    assert key(got) == key(want)
    assert [(r.n_batches, r.n_queries) for r in records] == \
        [(r.n_batches, r.n_queries) for r in ref_records]
    if algorithm == "spc":
        assert all(r.n_batches == 1 for r in records)
    else:
        assert len(records) < len(batches)


def test_measured_fusion_serves_the_same_answers(pool):
    rules, baskets = pool[0]
    batches = [baskets[i:i + 4] for i in range(0, 40, 4)]
    ref, _ = engines(rules)
    port = RuleServeEngine(port_rules(rules), algorithm="measured",
                           controller=CostController(
                               model=CostModel(persist=False)),
                           latency_budget_ms=5.0, device="cpu")
    got, records = port.serve(batches)
    assert key(got) == key(ref.serve(batches)[0])
    assert sum(r.n_queries for r in records) == 40
    assert any(d.site == "rule_serve_fusion"
               for d in port.controller.decisions)


def test_multi_tenant_arena_equals_reference(pool):
    (ra, ba), (rb, bb), (rc, bc) = pool
    ref_store = RefStore(tenants={"A": ra, "B": rb, "C": rc})
    ref, port = engines(ref_store, top_k=3)
    state = port.store.state
    np.testing.assert_array_equal(state.ante_masks,
                                  ref_store.state.ante_masks)
    np.testing.assert_array_equal(state.cons_masks,
                                  ref_store.state.cons_masks)
    assert state.offsets == ref_store.state.offsets
    names = tenant_mix(["A", "B", "C"], 60, seed=3)
    pools = {"A": ba, "B": bb, "C": bc}
    mixed = [(t, pools[t][i % 40] + [99]) for i, t in enumerate(names)]
    assert key(port.query(mixed)) == key(ref.query(mixed))
    with pytest.raises(KeyError, match="unknown tenant"):
        port.query([("Z", [0])])


def test_inf_scores_decode_and_empty_or_zero_answers(pool):
    rules, baskets = pool[0]
    boosted = dataclasses.replace(
        rules, score=np.where(np.arange(len(rules)) % 5 == 0, np.inf,
                              rules.score).astype(np.float32))
    ref, port = engines(boosted, dedup_consequents=False)
    got = port.query(baskets[:40], top_k=3)
    assert key(got) == key(ref.query(baskets[:40], top_k=3))
    assert any(r and r[0].score == np.inf for r in got)
    assert port.query(baskets[:3], top_k=0) == [[], [], []]
    assert port.query([[], [999, 10_000]]) == [[], []]

    empty = dataclasses.replace(
        rules, **{f: getattr(rules, f)[:0] for f in (
            "ante_masks", "cons_masks", "union_counts", "ante_counts",
            "cons_counts", "confidence", "lift", "leverage", "score")})
    results, records = RuleServeEngine(port_rules(empty),
                                       device="cpu").serve([[[0, 1]]])
    assert results == [[[]]] and records == []


def test_swap_rules_is_atomic_under_a_concurrent_writer(pool):
    """A writer swaps tenant A between two RuleSets while a reader serves
    mixed batches: every answer for A is exactly one set's answer, never a
    mixture, and B's answers never change."""
    (ra1, ba), (rb, bb), (ra2, _) = pool
    store = RuleStore(tenants={"A": port_rules(ra1), "B": port_rules(rb)},
                      device="cpu")
    eng = RuleServeEngine(store, top_k=3, device="cpu")
    qa, qb = ba[:6], bb[:6]
    want_a = {tag: key(RefEngine(r, impl="jnp", top_k=3,
                                 autotune=False).query(qa))
              for tag, r in (("v1", ra1), ("v2", ra2))}
    want_b = key(RefEngine(rb, impl="jnp", top_k=3,
                           autotune=False).query(qb))
    mixed = [p for pair in zip([("A", b) for b in qa],
                               [("B", b) for b in qb]) for p in pair]
    n_swaps, errors = 6, []

    def writer():
        try:
            for i in range(n_swaps):
                store.swap_rules("A", port_rules(ra2 if i % 2 == 0 else ra1))
        except Exception as e:             # pragma: no cover
            errors.append(e)

    wt = threading.Thread(target=writer)
    wt.start()
    for _ in range(12):
        got = key(eng.query(mixed))
        assert got[0::2] in (want_a["v1"], want_a["v2"])
        assert got[1::2] == want_b
    wt.join()
    assert not errors
    assert store.version("A") == n_swaps and store.version("B") == 0
    assert key(eng.query(mixed))[0::2] == want_a["v1"]

    single = RuleServeEngine(port_rules(ra1), top_k=3, device="cpu")
    single.swap_rules(port_rules(ra2), warm_to=16)
    assert single.store.version(DEFAULT_TENANT) == 1
    assert key(single.query(qa)) == want_a["v2"]


def _drive(server, baskets, times, tenants):
    for b, t, name in zip(baskets, times, tenants):
        server.submit(b, float(t), tenant=name)
    server.flush()


@pytest.mark.parametrize("cost,fair", [(constant_cost(0.004), True),
                                       (per_query_cost(0.0015, 0.001), True),
                                       (per_query_cost(0.0015, 0.001), False)])
def test_open_loop_outcomes_equal_reference(pool, cost, fair):
    """Scripted dispatch costs on a virtual clock: every query's outcome,
    latency, dispatch and answer is the reference server's, exactly."""
    (ra, ba), (rb, bb), _ = pool
    ref_store = RefStore(tenants={"A": ra, "B": rb})
    ref, port = engines(ref_store, top_k=3)
    n = 120
    names = tenant_mix(["A", "B"], n, seed=5, weights=[4, 1])
    pools = {"A": ba, "B": bb}
    baskets = [pools[t][i % 60] for i, t in enumerate(names)]
    times = arrivals(1500.0, n, seed=9)
    outs = {}
    for side, eng, srv_cls, ctrl in (
            ("ref", ref, RefServer,
             RefController(model=RefCostModel(persist=False))),
            ("port", port, OpenLoopServer,
             CostController(model=CostModel(persist=False)))):
        kw = {"clock": FakeClock()} if side == "port" else {}
        srv = srv_cls(eng, latency_slo_ms=6.0, batch=4, max_wait_ms=2.0,
                      cache_size=16, fair_shedding=fair, controller=ctrl,
                      dispatch_cost_fn=cost, **kw)
        _drive(srv, baskets, times, names)
        outs[side] = (srv.summary(), [o.as_dict() for o in srv.outcomes],
                      [key(o.results) if o.results is not None else None
                       for o in srv.outcomes])
    assert outs["port"] == outs["ref"]
    summary = outs["port"][0]
    assert summary["shed"] > 0 and summary["cached"] > 0


def _cli_lines(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        main(argv)
    return [ln for ln in buf.getvalue().splitlines()
            if ln.startswith(("  recommend", "mined ", "rules:",
                              "sample query"))]


@pytest.mark.parametrize("extra", [[], ["--tenants", "3"],
                                   ["--algorithm", "spc", "--impl", "jnp"]])
def test_serve_rules_cli_prints_the_reference_recommendations(
        monkeypatch, extra):
    from repro.launch import serve_rules as ref_cli
    from repro_torch.launch import serve_rules as port_cli
    argv = ["--dataset", "mushroom", "--scale", "0.06", "--min-sup", "0.35",
            "--min-conf", "0.7", "--queries", "48", "--batch", "8", *extra]

    def ref_main(args):
        monkeypatch.setattr(sys, "argv", ["serve_rules", *args])
        ref_cli.main()
    want = _cli_lines(ref_main, argv)
    got = _cli_lines(port_cli.main, argv + ["--device", "cpu"])
    strip = (lambda lines: [ln.split(" in ")[0] if ln.startswith(
        ("mined ", "rules:")) else ln for ln in lines])
    assert any(ln.startswith("  recommend") for ln in got)
    assert strip(got) == strip(want)


def test_impl_names_and_devices_are_checked(monkeypatch, pool):
    rules = port_rules(pool[0][0])
    for bad in ("pallas", "matmul_pallas_interpret"):
        with pytest.raises(ValueError, match="'jnp' .popcount kernel. and "
                                             "'matmul'"):
            RuleServeEngine(rules, impl=bad, device="cpu")
    assert RuleServeEngine(rules, device="cpu").family == "jnp"
    store = RuleStore(rules, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="lives on cpu"):
        RuleServeEngine(store, device="cuda")


def test_default_device_raises_without_a_card(monkeypatch, pool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rules = port_rules(pool[0][0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RuleServeEngine(rules)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RuleStore(rules)
