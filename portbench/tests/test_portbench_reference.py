"""The plain reference equals the port's plain ``device="cpu"`` path: the
levels of both configurations, and the serving cell's rules and answers."""

import numpy as np
import pytest

from portbench.data.generators import drop_one_queries, pack, unpack
from portbench.drivers import mining, open_loop
from portbench.tests.helpers import context

SEEDS = [1, 2**33 + 7]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", ["mine.c20d200k", "mine.mushroom"])
def test_levels_equal_the_port(cell, seed):
    from repro_torch.core.mapreduce import MapReduceRuntime
    _, ctx = context(cell, seed=seed)
    rows, db = mining.inputs(ctx.config, seed)
    assert np.array_equal(unpack(db, rows.shape[1]), rows)
    res = mining.mine_once(db, ctx.config, MapReduceRuntime(device="cpu"))
    want = mining.reference(rows, ctx.config)
    assert mining.frequent(want) > 100
    assert mining.check([res.levels], want) == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_rules_and_answers_equal_the_port(seed):
    _, ctx = context("serve.mushroom-4t", seed=seed)
    svc = open_loop.Service(ctx.config, "cpu")
    want_rules = open_loop.reference_rules(ctx.config, svc.slices)
    for t, rs in svc.store.state.rulesets.items():
        assert open_loop.ruleset_mismatches(open_loop.rule_arrays(rs),
                                            want_rules[t]) == 0
    rng = np.random.default_rng(seed)
    _, tenants, baskets = open_loop.schedule(rng, 300.0, 1.0, svc.slices)
    got, _ = svc.engine.serve([list(zip(tenants, baskets))])
    want = open_loop.reference_answers(ctx.config, want_rules, svc.fetch,
                                       tenants, baskets, "cpu")
    assert sum(1 for w in want if w) > 200
    assert [[(r.consequent, r.score) for r in g] for g in got[0]] == want


def test_generators_draw_the_configured_shapes():
    _, ctx = context("mine.c20d200k")
    rows, db = mining.inputs(ctx.config, 3)
    assert rows.shape == (3000, 192) and db.shape == (3000, 6)
    assert abs(rows.sum(1).mean() - 20) < 1.0
    _, ctx = context("mine.mushroom")
    rows, _ = mining.inputs(ctx.config, 3)
    assert rows.shape == (8124, 119) and (rows.sum(1) == 23).all()
    qs = drop_one_queries(np.random.default_rng(0), rows, 50)
    assert all(len(q) == 22 for q in qs)
    assert np.array_equal(unpack(pack(rows), 119), rows)
