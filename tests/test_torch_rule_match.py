"""The port's rule-scoring kernels (plain versions on the CPU) and its
top-k against the JAX package's.

Every score matrix must have the reference's float32 bits: ``score[r]``
where the rule fires, ``-inf`` elsewhere.  The reference runs its jnp forms
and its Pallas kernels in interpret mode.  The CUDA kernels run only on a
card (``test_torch_gpu.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import generate_ruleset as ref_generate_ruleset
from repro.core import mine as ref_mine
from repro.core.bitset import pack_itemsets
from repro.kernels.rule_match import (rule_scores_jnp, rule_scores_matmul,
                                      rule_scores_matmul_pallas,
                                      rule_scores_pallas)
from repro_torch import kernels
from repro_torch.core.bitset import to_device_words
from repro_torch.kernels.rule_match import (rule_scores_matmul_plain,
                                            rule_scores_plain)
from repro_torch.serving import stable_top_k

PORT = {"rule_scores": kernels.rule_scores,
        "rule_scores_plain": rule_scores_plain,
        "rule_scores_matmul": kernels.rule_scores_matmul,
        "rule_scores_matmul_plain": rule_scores_matmul_plain}


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _reference(antes, cons, scores, baskets, exclude):
    """Every reference form, which must agree with each other; returns the
    jnp form's matrix."""
    want = np.asarray(rule_scores_jnp(antes, cons, scores, baskets,
                                      q_block=16, exclude_contained=exclude))
    others = {
        "matmul": rule_scores_matmul(antes, cons, scores, baskets,
                                     q_block=16, exclude_contained=exclude),
        "pallas_interpret": rule_scores_pallas(
            antes, cons, scores, baskets, bq=16, br=32,
            exclude_contained=exclude, interpret=True),
        "matmul_pallas_interpret": rule_scores_matmul_pallas(
            antes, cons, scores, baskets, bq=16, br=32,
            exclude_contained=exclude, interpret=True),
    }
    for name, got in others.items():
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=name)
    return want


def _port(antes, cons, scores, baskets, exclude, fn):
    return PORT[fn](to_device_words(antes, "cpu"), to_device_words(cons, "cpu"),
                    torch.from_numpy(np.array(scores, np.float32)),
                    to_device_words(baskets, "cpu"), exclude).numpy()


@pytest.fixture(scope="module")
def mined_rules():
    """The ``test_rules_engine.py`` fixture: a mined RuleSet and baskets."""
    rng = np.random.default_rng(7)
    base = rng.random((3, 12)) < 0.5
    txns = []
    for _ in range(120):
        pat = base[rng.integers(3)]
        row = np.where(rng.random(12) < 0.85, pat, rng.random(12) < 0.1)
        txns.append(np.nonzero(row)[0].tolist() or [0])
    rules = ref_generate_ruleset(ref_mine(txns, n_items=12, min_sup=0.3),
                                 min_confidence=0.6)
    baskets = [sorted(set(t[:-1])) or [0] for t in txns[:40]]
    return rules, pack_itemsets(baskets, 12)


@pytest.mark.parametrize("exclude", [True, False])
@pytest.mark.parametrize("fn", sorted(PORT))
def test_mined_rules_match_reference(mined_rules, fn, exclude):
    rules, packed = mined_rules
    args = (rules.ante_masks, rules.cons_masks, rules.score, packed)
    want = _reference(*args, exclude)
    assert np.isfinite(want).any() and np.isneginf(want).any()
    np.testing.assert_array_equal(_bits(_port(*args, exclude, fn)),
                                  _bits(want))


def _random_case(R, Q, W, seed):
    rng = np.random.default_rng(seed)

    def sparse(n):       # AND of three draws: about an eighth of the bits
        return (rng.integers(0, 2**32, (n, W), dtype=np.uint32)
                & rng.integers(0, 2**32, (n, W), dtype=np.uint32)
                & rng.integers(0, 2**32, (n, W), dtype=np.uint32))
    antes, cons, baskets = sparse(R), sparse(R), ~sparse(Q)
    antes[-1] = 0                           # an empty antecedent: always fires
    cons[0] = 0                             # an empty consequent: never novel
    baskets[0] = 0xFFFFFFFF                 # bit 31 of every word set
    scores = rng.random(R).astype(np.float32)
    scores[R // 2] = np.inf                 # +inf is a legal score
    return antes, cons, scores, baskets


# ragged Q and R (neither a tile multiple), W = 1 … 9
SHAPES = [(1, 1, 1), (37, 13, 2), (300, 70, 3), (513, 17, 4), (90, 33, 9)]


@pytest.mark.parametrize("R,Q,W", SHAPES)
@pytest.mark.parametrize("exclude", [True, False])
def test_ragged_shapes_match_reference(R, Q, W, exclude):
    args = _random_case(R, Q, W, seed=R * Q + W)
    want = _reference(*args, exclude)
    for fn in PORT:
        np.testing.assert_array_equal(_bits(_port(*args, exclude, fn)),
                                      _bits(want), err_msg=fn)


@pytest.mark.parametrize("q_block", [1, 5, 64])
def test_plain_versions_do_not_depend_on_block(q_block):
    antes, cons, scores, baskets = _random_case(41, 29, 2, seed=q_block)
    want = _reference(antes, cons, scores, baskets, True)
    t = [to_device_words(x, "cpu") for x in (antes, cons)]
    s, b = torch.from_numpy(scores), to_device_words(baskets, "cpu")
    for fn in (rule_scores_plain, rule_scores_matmul_plain):
        np.testing.assert_array_equal(
            _bits(fn(*t, s, b, True, q_block=q_block).numpy()), _bits(want))


def _tied_scores(seed, Q=9, R=300):
    """Few distinct values, -inf no-match slots and +inf, as a served
    score matrix has them."""
    rng = np.random.default_rng(seed)
    levels = np.array([0.5, 1.0, 1.25, 2.0, np.inf, -np.inf], np.float32)
    s = levels[rng.integers(0, len(levels), (Q, R))]
    s[0] = -np.inf                          # a basket nothing fires for
    s[1, :] = 1.0                           # one value across a whole row
    return s


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [1, 7, 40, 300])
def test_top_k_breaks_ties_like_lax_top_k(seed, k):
    """Hazard: ``torch.topk`` leaves the order of equal scores open;
    ``lax.top_k`` puts the lower index first.  ``stable_top_k`` gives the
    reference's values and indices exactly."""
    s = _tied_scores(seed)
    want_v, want_i = jax.lax.top_k(jnp.asarray(s), k)
    got_v, got_i = stable_top_k(torch.from_numpy(s), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(_bits(got_v.numpy()), _bits(want_v))


def test_top_k_on_a_served_matrix(mined_rules):
    rules, packed = mined_rules
    ties = dataclasses.replace(rules, score=np.round(rules.score, 1))
    s = _reference(ties.ante_masks, ties.cons_masks, ties.score, packed, True)
    k = len(rules)
    want_v, want_i = jax.lax.top_k(jnp.asarray(s), k)
    got_v, got_i = stable_top_k(torch.from_numpy(s.copy()), k)
    live = ~np.isneginf(np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy()[live], np.asarray(want_i)[live])
    np.testing.assert_array_equal(_bits(got_v.numpy()), _bits(want_v))


def test_wrappers_refuse_mismatched_arguments():
    meta = torch.empty((4, 2), dtype=torch.int32, device="meta")
    scores = torch.empty(4, dtype=torch.float32, device="meta")
    for fn in (kernels.rule_scores, kernels.rule_scores_matmul):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(meta, meta, scores, meta)
