"""The control (the reference one precision step down in the port's place)
fails the checks that sound runs pass; the chip runs it at the cells' sizes
(``python3 portbench/control.py``), this test at a small one."""

import numpy as np
import torch

from portbench import control
from portbench.drivers import mining, open_loop
from portbench.tests.helpers import context


def test_half_precision_counts_fail_the_mining_check():
    for cell in ("mine.c20d200k", "mine.mushroom"):
        man, ctx = context(cell)
        full = man.config(ctx.cell)        # the cell's own size: numpy only
        assert control.mining_control(full, 5)["itemsets_wrong"] > 0
        rows, _ = mining.inputs(ctx.config, 5)
        want = mining.reference(rows, ctx.config)
        assert mining.check([want], want) == 0


def test_bfloat16_scores_fail_the_serving_checks():
    _, ctx = context("serve.mushroom-4t", rate=200.0)
    out = control.serving_control(ctx.config, ctx.traffic, 1.0, 5, "cpu")
    assert out["answers"] == 200
    assert out["rules_wrong"] > 0 and out["answers_wrong"] > 0


def test_the_exact_reference_passes_its_own_checks():
    _, ctx = context("serve.mushroom-4t")
    rows = {"t0": mining.inputs(ctx.config, 0)[0][::4]}
    a = open_loop.reference_rules(ctx.config, rows)
    b = open_loop.reference_rules(ctx.config, rows,
                                  score_dtype=torch.float32)
    assert open_loop.ruleset_mismatches(a["t0"], b["t0"]) == 0
    assert a["t0"]["score"].dtype == np.float32
