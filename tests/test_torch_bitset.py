"""The port's bit-set algebra, candidate generation, policies and data
generator against the JAX package on the same numpy inputs.

Everything here is integer or host numpy code, so every comparison is exact.
The cases are those of ``test_bitset.py`` and ``test_candidates.py``, run
through both packages; the device helpers (``tpopcount_rows``,
``tunpack_bits``, ``tpack_bits``) are held against ``jpopcount_rows``,
``junpack_bits`` and ``jpack_bits``, including words with bit 31 set (an
int32 view of such a word is negative, and an arithmetic shift copies the
sign bit).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypothesis_compat import given, settings, st

import repro.core.bitset as rb
import repro.core.candidates as rc
import repro.core.policy as rp
import repro.data.generator as rg
import repro_torch.core.bitset as tb
import repro_torch.core.candidates as tc
import repro_torch.core.policy as tp
import repro_torch.data.generator as tg

N_ITEMS = 40

itemsets_strategy = st.lists(
    st.lists(st.integers(0, 90), min_size=0, max_size=12)
    .map(lambda x: sorted(set(x))),
    min_size=1, max_size=40)


def _random_sets(seed, n, k, n_items=N_ITEMS):
    rng = np.random.default_rng(seed)
    return sorted({tuple(sorted(rng.choice(n_items, k, replace=False)))
                   for _ in range(n)})


def _masks(sets, n_items=N_ITEMS):
    return rb.pack_itemsets([list(t) for t in sets], n_items)


# -- host bit-set helpers --------------------------------------------------------

@given(itemsets_strategy)
@settings(max_examples=40, deadline=None)
def test_host_helpers_match_reference(itemsets):
    ref = rb.pack_itemsets(itemsets, 91)
    got = tb.pack_itemsets(itemsets, 91)
    np.testing.assert_array_equal(got, ref)
    assert tb.unpack_itemsets(got) == rb.unpack_itemsets(ref)
    np.testing.assert_array_equal(tb.popcount_rows(got), rb.popcount_rows(ref))
    np.testing.assert_array_equal(tb.highest_bit_index(got),
                                  rb.highest_bit_index(ref))
    np.testing.assert_array_equal(tb.lowest_bit_index(got),
                                  rb.lowest_bit_index(ref))
    np.testing.assert_array_equal(tb.hash_rows(got), rb.hash_rows(ref))


@pytest.mark.parametrize("n_items", [1, 31, 32, 33, 70, 192])
def test_singletons_and_vertical_pack_match_reference(n_items):
    np.testing.assert_array_equal(tb.singleton_masks(n_items),
                                  rb.singleton_masks(n_items))
    rng = np.random.default_rng(n_items)
    db = rng.integers(0, 2**32, (101, rb.n_words(n_items)), dtype=np.uint32)
    db &= rb.pack_itemsets([list(range(n_items))], n_items)[0]
    np.testing.assert_array_equal(tb.vertical_pack(db, n_items),
                                  rb.vertical_pack(db, n_items))


@given(itemsets_strategy, itemsets_strategy)
@settings(max_examples=30, deadline=None)
def test_mask_index_matches_reference(base, queries):
    bm = tb.pack_itemsets(base, 91)
    qm = tb.pack_itemsets(queries, 91)
    np.testing.assert_array_equal(tb.MaskIndex(bm).find(qm),
                                  rb.MaskIndex(bm).find(qm))


# -- device helpers on int32 views -----------------------------------------------

def _words_with_sign_bit(shape, seed=0):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, shape, dtype=np.uint32)
    words[0, :] = 0x80000000          # bit 31 alone: int32 view is INT32_MIN
    words[1, :] = 0xFFFFFFFF          # every bit: int32 view is -1
    words[2, :] = 0
    return words


@pytest.mark.parametrize("W", [1, 3, 8])
def test_tunpack_bits_matches_junpack_on_bit31(W):
    words = _words_with_sign_bit((13, W), seed=W)
    ref = np.asarray(rb.junpack_bits(jnp.asarray(words)))
    got = tb.tunpack_bits(tb.to_device_words(words, "cpu"))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), ref)
    assert set(np.unique(got.numpy())) <= {0, 1}
    assert got[0, 31] == 1 and got[0, :31].sum() == 0


@pytest.mark.parametrize("W", [1, 3, 8])
def test_tpopcount_and_tpack_match_reference(W):
    words = _words_with_sign_bit((17, W), seed=10 + W)
    dev = tb.to_device_words(words, "cpu")
    np.testing.assert_array_equal(
        tb.tpopcount_rows(dev).numpy(),
        np.asarray(rb.jpopcount_rows(jnp.asarray(words))))
    planes = rb.junpack_bits(jnp.asarray(words))
    packed = tb.tpack_bits(torch.from_numpy(np.array(planes)))
    np.testing.assert_array_equal(tb.to_host_words(packed),
                                  np.asarray(rb.jpack_bits(planes)))
    np.testing.assert_array_equal(tb.to_host_words(packed), words)


def test_tpack_bits_pads_ragged_width_like_jpack():
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, (9, 45)).astype(np.int8)
    ref = np.asarray(rb.jpack_bits(jnp.asarray(bits)))
    got = tb.to_host_words(tb.tpack_bits(torch.from_numpy(bits)))
    np.testing.assert_array_equal(got, ref)


# -- candidate generation --------------------------------------------------------

@pytest.mark.parametrize("k,n,seed", [(1, 30, 0), (2, 60, 1), (3, 120, 2),
                                      (4, 300, 3)])
def test_generation_matches_reference(k, n, seed):
    prev = _masks(_random_sets(seed, n, k))
    for gen in ("join", "apriori_gen", "non_apriori_gen"):
        got = getattr(tc, gen)(prev, k)
        ref = getattr(rc, gen)(prev, k)
        np.testing.assert_array_equal(got, ref, err_msg=gen)


@given(st.lists(st.lists(st.integers(0, N_ITEMS - 1), min_size=3, max_size=3,
                         unique=True).map(lambda x: tuple(sorted(x))),
                min_size=0, max_size=25, unique=True))
@settings(max_examples=30, deadline=None)
def test_join_and_prune_match_reference_property(prev_sets):
    prev = _masks(prev_sets)
    joined = tc.join(prev, 3)
    np.testing.assert_array_equal(joined, rc.join(prev, 3))
    np.testing.assert_array_equal(tc.prune(joined, prev, 3),
                                  rc.prune(joined, prev, 3))


def test_join_block_size_and_prune_closure():
    prev = _masks(_random_sets(0, 300, 4))
    np.testing.assert_array_equal(tc.join(prev, 4), rc.join(prev, 4))
    small = _masks([(0, 1), (0, 2), (1, 2), (3, 4)])
    kept = tc.prune(tc.join(small, 2), small, 2)
    assert set(tb.unpack_itemsets(kept)) == {(0, 1, 2)}


def test_speculative_join_resolves_like_reference():
    cands = _masks(_random_sets(4, 80, 2))
    keep = np.random.default_rng(4).random(cands.shape[0]) < 0.6
    got = tc.speculative_join(cands, 2).resolve(keep)
    ref = rc.speculative_join(cands, 2).resolve(keep)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, rc.join(cands[keep], 2))


# -- policies and data -----------------------------------------------------------

PAPER_POLICIES = [name for name, (cls, _) in rp.ALGORITHMS.items()
                  if cls is not rp.MeasuredPolicy]


def test_algorithm_table_matches_reference():
    assert sorted(tp.ALGORITHMS) == sorted(rp.ALGORITHMS)
    for name, (cls, optimized) in rp.ALGORITHMS.items():
        assert tp.ALGORITHMS[name][0].__name__ == cls.__name__
        assert tp.ALGORITHMS[name][1] == optimized


@pytest.mark.parametrize("algorithm", PAPER_POLICIES)
def test_paper_policy_decisions_match_reference(algorithm):
    """The same phase histories give the same (mode, value) decisions;
    elapsed times straddle the 40/60 ms thresholds."""
    rng = np.random.default_rng(len(algorithm))
    ref = rp.ALGORITHMS[algorithm][0]()
    got = tp.ALGORITHMS[algorithm][0]()
    hist = []
    for _ in range(12):
        hist.append((int(rng.integers(1, 5000)), int(rng.integers(0, 500)),
                     float(rng.random() * 0.12)))
        prev = hist[-1]
        prev2 = hist[-2] if len(hist) > 1 else None
        want = ref.decide(rp.PhaseStats(*prev),
                          rp.PhaseStats(*prev2) if prev2 else None)
        have = got.decide(tp.PhaseStats(*prev),
                          tp.PhaseStats(*prev2) if prev2 else None)
        assert have == want


@pytest.mark.parametrize("name,scale", [("c20d10k", 0.02), ("c20d200k", 0.001),
                                        ("chess", 0.05), ("mushroom", 0.03)])
def test_generator_matches_reference(name, scale):
    assert tg.dataset_by_name(name, seed=3, scale=scale) == \
        rg.dataset_by_name(name, seed=3, scale=scale)
