"""The port's rule generation against the JAX package's.

The same mined levels go through ``repro.core.rules.generate_ruleset`` and
``repro_torch.core.rules.generate_ruleset`` (on the CPU); every RuleSet
array must be bitwise equal — masks, integer counts and the four float32
metric columns, leverage included.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import mine as ref_mine
from repro.core.rules import generate_rules as ref_generate_rules
from repro.core.rules import generate_ruleset as ref_generate_ruleset
from repro.data import dataset_by_name
from repro_torch.core import (MiningResult, RuleSet, generate_rules,
                              generate_ruleset, mine, sequential_apriori)
from repro_torch.core.rules import MAX_RULE_K

FIELDS = [f.name for f in dataclasses.fields(RuleSet)]


def _patterned(seed, n_items, n_txns):
    """The ``test_rules.py`` generator: three base patterns plus noise."""
    rng = np.random.default_rng(seed)
    base = rng.random((3, n_items)) < 0.5
    txns = []
    for _ in range(n_txns):
        pat = base[rng.integers(3)]
        row = np.where(rng.random(n_items) < 0.85, pat,
                       rng.random(n_items) < 0.1)
        txns.append(np.nonzero(row)[0].tolist() or [0])
    return txns


def _as_port_result(ref_res) -> MiningResult:
    """The reference's MiningResult as the port's (levels carry across as
    they are)."""
    return MiningResult(**{f.name: getattr(ref_res, f.name)
                           for f in dataclasses.fields(MiningResult)})


def _assert_bitwise_equal(got: RuleSet, want) -> None:
    assert (got.n_items, got.n_txns) == (want.n_items, want.n_txns)
    for name in FIELDS[2:]:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


# (dataset, scale, min_sup, min_conf): mushroom at full width is the serving
# configuration's catalog; the patterned sets reach deep levels
CASES = {
    "mushroom": (lambda: dataset_by_name("mushroom", seed=0, scale=0.25),
                 0.25, 0.7),
    "patterned16": (lambda: (_patterned(2, 16, 150), 16), 0.3, 0.6),
    "patterned12": (lambda: (_patterned(7, 12, 120), 12), 0.3, 0.0),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def mined(request):
    make, min_sup, min_conf = CASES[request.param]
    txns, n_items = make()
    res = ref_mine(txns, n_items=n_items, min_sup=min_sup)
    return res, min_conf


def test_ruleset_bitwise_equal_with_fused_leverage(mined):
    """Hazard: XLA fuses the reference's float32 leverage
    ``u/n - (a/n)*(c/n)`` into one multiply-add; step-by-step float32
    differs in the last bit on most rules.  The port's RuleSet equals the
    reference's bitwise, and on these levels the step-by-step form does
    not."""
    res, min_conf = mined
    want = ref_generate_ruleset(res, min_confidence=min_conf)
    got = generate_ruleset(_as_port_result(res), min_conf, device="cpu")
    assert len(got) > 0
    _assert_bitwise_equal(got, want)
    u, a, c = (torch.from_numpy(x).to(torch.float32)
               for x in (got.union_counts, got.ante_counts, got.cons_counts))
    n = torch.tensor(float(got.n_txns))
    naive = (u / n - (a / n) * (c / n)).numpy()
    assert (naive.view(np.uint32) != want.leverage.view(np.uint32)).any()


def test_decoded_rules_equal(mined):
    res, min_conf = mined
    want = ref_generate_rules(res, min_confidence=min_conf, max_rules=200)
    got = generate_rules(_as_port_result(res), min_conf, max_rules=200,
                         device="cpu")
    assert [dataclasses.astuple(r) for r in got] == \
        [dataclasses.astuple(r) for r in want]


def test_port_pipeline_equals_reference_end_to_end():
    """Mining and rules both in the port, from the same transactions."""
    txns = _patterned(3, 14, 160)
    res = mine(txns, n_items=14, min_sup=0.3, device="cpu")
    assert res.itemsets() == sequential_apriori(txns, 0.3)
    got = generate_ruleset(res, 0.5, device="cpu")
    want = ref_generate_ruleset(ref_mine(txns, n_items=14, min_sup=0.3), 0.5)
    _assert_bitwise_equal(got, want)


def test_from_arrays_carries_a_reference_ruleset(mined):
    res, min_conf = mined
    want = ref_generate_ruleset(res, min_confidence=min_conf)
    got = RuleSet.from_arrays(**dataclasses.asdict(want))
    _assert_bitwise_equal(got, want)
    assert [dataclasses.astuple(r) for r in got.to_rules(50)] == \
        [dataclasses.astuple(r) for r in want.to_rules(50)]


def test_empty_and_degenerate_levels():
    empty = MiningResult(algorithm="spc", min_sup=0.9, n_txns=4, n_items=40,
                         levels={}, phases=[], total_seconds=0.0,
                         dispatches=0, compiles=0)
    rs = generate_ruleset(empty, device="cpu")
    assert len(rs) == 0 and rs.ante_masks.shape == (0, 2)
    deep = np.zeros((1, 1), np.uint32)
    deep[0, 0] = (1 << (MAX_RULE_K + 1)) - 1
    too_deep = dataclasses.replace(
        empty, levels={MAX_RULE_K + 1: (deep, np.array([3]))})
    with pytest.raises(ValueError, match="MAX_RULE_K"):
        generate_ruleset(too_deep, device="cpu")


def test_default_device_raises_without_a_card(monkeypatch, mined):
    res, min_conf = mined
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_ruleset(_as_port_result(res), min_conf)
