"""Candidate generation's device path on the CPU: the plain PyTorch version
of the join and prune kernels (``kernels/candidate_gen.py``) against the
numpy join and prune of ``core/candidates.py``, byte for byte, on the
property cases of ``test_torch_bitset.py``; the ordering lemma the kernels
rest on, pinned on the numpy join; and the host paths that stay on numpy.

``candidates._join_on`` and ``_prune_on`` are the card path's orchestration
(upload, sort of a level out of order, parents mapped back, copy home); on
a CPU device they run the plain version, so everything around the kernels
runs here.  The kernels themselves are held against the plain version in
``test_torch_gpu.py``.
"""

import re

import numpy as np
import pytest
import torch

from hypothesis_compat import given, settings, st

import repro_torch.core.candidates as tc
from repro_torch import kernels
from repro_torch.core.bitset import (highest_bit_index, pack_itemsets,
                                     to_device_words, to_host_words)
from repro_torch.core.drivers import mine
from repro_torch.costmodel import CostController, CostModel
from repro_torch.data.generator import mushroom_like
from repro_torch.kernels import _build
from repro_torch.kernels import candidate_gen as cg
from repro_torch.obs.trace import Tracer, use_tracer
from repro_torch.stream.tables import (TrackedTables, build_tracked_levels,
                                       derive_frequent)

N_ITEMS = 40
CPU = torch.device("cpu")


def _random_sets(seed, n, k, n_items=N_ITEMS):
    rng = np.random.default_rng(seed)
    return sorted({tuple(sorted(rng.choice(n_items, k, replace=False)))
                   for _ in range(n)})


def _masks(sets, n_items=N_ITEMS):
    return pack_itemsets([list(t) for t in sets], n_items)


def _canonical(masks):
    return masks[np.lexsort(masks.T)]


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def _device_path_equals_numpy(prev, k):
    """The device path on the CPU (plain version) against the numpy path:
    the join with its parents, the join alone and the prune of the join."""
    for got, want in zip(tc._join_on(prev, CPU), tc.join_pairs(prev, k)):
        _same(got, want)
    joined = tc.join_pairs(prev, k)[0]
    _same(tc._join_on(prev, CPU, parents=False)[0], joined)
    _same(tc._prune_on(joined, prev, CPU), tc._prune(joined, prev, k))
    if prev.shape[0] >= 2:
        _same(tc._apriori_gen_on(prev, k, CPU), tc.apriori_gen(prev, k))


@pytest.mark.parametrize("k,n,seed", [(1, 30, 0), (2, 60, 1), (3, 120, 2),
                                      (4, 300, 3)])
def test_plain_version_equals_numpy(k, n, seed):
    prev = _masks(_random_sets(seed, n, k))
    _device_path_equals_numpy(prev, k)
    # the wrapper's own tensors: a canonical level's int32 words in, the
    # same bits out
    prev = _canonical(prev)
    words = to_device_words(prev, CPU)
    cands, left, right = cg.join_words(words)
    want = tc.join_pairs(prev, k)
    _same(to_host_words(cands), want[0])
    _same(left.numpy(), want[1])
    _same(right.numpy(), want[2])
    _same(to_host_words(cg.prune_words(cands, words)),
          tc._prune(want[0], prev, k))


@given(st.lists(st.lists(st.integers(0, N_ITEMS - 1), min_size=3, max_size=3,
                         unique=True).map(lambda x: tuple(sorted(x))),
                min_size=0, max_size=25, unique=True))
@settings(max_examples=30, deadline=None)
def test_plain_version_equals_numpy_property(prev_sets):
    """In the order drawn: out of canonical order the level is sorted on the
    way and left/right mapped back to the rows given."""
    _device_path_equals_numpy(_masks(prev_sets), 3)


@given(st.lists(st.lists(st.integers(0, 90), min_size=0, max_size=12)
                .map(lambda x: sorted(set(x))), min_size=1, max_size=40),
       st.integers(1, 5))
@settings(max_examples=40, deadline=None)
def test_plain_version_equals_numpy_on_wide_rows(itemsets, k):
    """Three words a row, items on bits 31 and 63, rows of mixed sizes
    (the empty row too), each drawn itemset cut to its first ``k`` items."""
    rows = sorted({tuple(s[:k]) for s in itemsets} | {(31, 63), (63,)})
    _device_path_equals_numpy(_canonical(_masks(rows, 91)), k)


def test_plain_version_equals_every_numpy_join():
    prev = _masks(_random_sets(0, 300, 4))
    for got, want in zip(tc._join_on(prev, CPU), tc.join_pairs(prev, 4)):
        _same(got, want)


def test_plain_speculative_join_resolves_like_numpy():
    cands = _masks(_random_sets(4, 80, 2))
    keep = np.random.default_rng(4).random(cands.shape[0]) < 0.6
    want = tc.speculative_join(cands, 2)
    out, left, right = tc._join_on(cands, CPU)
    spec = tc.SpecJoin(out, left, right, n_src=cands.shape[0], k=3)
    _same(spec.resolve(keep), want.resolve(keep))
    _same(spec.resolve(keep), tc.join(cands[keep], 2))


@given(st.lists(st.lists(st.integers(0, 70), min_size=1, max_size=4,
                         unique=True).map(lambda x: tuple(sorted(x))),
                min_size=2, max_size=60, unique=True))
@settings(max_examples=40, deadline=None)
def test_numpy_join_orders_by_top_item_then_lower_parent(sets):
    """The lemma the kernels rest on, on the numpy join of a canonical
    level: the output is sorted by (highest item, left), left < right, the
    candidate's highest item is its higher parent's, and below it the
    candidate is its lower parent."""
    prev = _canonical(_masks(sets, 71))
    cands, left, right = tc.join_pairs(prev, 0)
    top = highest_bit_index(cands)
    assert (left < right).all()
    np.testing.assert_array_equal(top, highest_bit_index(prev[right]))
    order = np.lexsort((left, top))
    np.testing.assert_array_equal(order, np.arange(cands.shape[0]))
    np.testing.assert_array_equal(cands, prev[left] | prev[right])
    below = cands.copy()
    for r, t in enumerate(top):
        below[r, t // 32] ^= np.uint32(1 << (t % 32))
    np.testing.assert_array_equal(below, prev[left])


def test_plain_version_refuses_what_the_kernels_refuse():
    level = _canonical(_masks(_random_sets(5, 150, 3, n_items=9)))
    words = to_device_words(level, CPU)
    cands = cg.join_words(words)[0]
    kept = to_host_words(cg.prune_words(cands, words))
    assert 0 < kept.shape[0] < cands.shape[0]
    with pytest.raises(cg.UnsortedLevel):
        cg.join_words(words.flip(0))
    with pytest.raises(cg.UnsortedLevel):
        cg.join_words(torch.cat([words, words[-1:]]))       # a row twice
    with pytest.raises(cg.UnsortedLevel):
        cg.prune_words(words, words.flip(0))
    # the prune takes equal rows in its level: a membership test
    _same(to_host_words(cg.prune_words(cands, words.repeat_interleave(2, 0))),
          kept)
    # the device path sorts a level out of order; a row twice it refuses
    with pytest.raises(ValueError, match="twice"):
        tc._join_on(np.concatenate([level, level[:1]]), CPU)


def test_the_scan_blocks_are_the_sources():
    text = (_build.CSRC_DIR / "candidate_gen.cu").read_text()
    assert int(re.search(r"kScanBlocks = (\d+);", text).group(1)) == \
        cg.SCAN_BLOCKS


def test_generation_runs_on_the_card_only_for_a_card():
    assert tc._card(None) is None and tc._card("cpu") is None
    assert tc._card(CPU) is None
    assert tc._card("cuda:1") == torch.device("cuda:1")


def test_cpu_mine_and_stream_tables_launch_nothing():
    """A CPU runtime's mine and the streaming tables' generation run the
    numpy path: no kernel launches, every join and prune span carries
    ``on_device`` False."""
    rows, n_items = mushroom_like(n_txns=300, seed=5)
    kernels.reset_launches()
    tr = Tracer()
    with use_tracer(tr):
        res = mine(rows, n_items=n_items, min_sup=0.3,
                   algorithm="optimized_vfpc", device="cpu",
                   controller=CostController(CostModel(persist=False)))
        db = pack_itemsets(rows, n_items)
        min_count = 0.3 * len(rows)

        def count(masks):
            return [int(((db & m) == m).all(axis=1).sum()) for m in masks]
        tracked = build_tracked_levels(res.levels, n_items, min_count, 0.2,
                                       count)
        derived = derive_frequent(TrackedTables(tracked), min_count)
    assert derived is not None and derived.keys() == res.levels.keys()
    assert not any(kernels.LAUNCHES.values())
    spans = [s for s in tr.spans if s.name in ("mine.join", "mine.prune")]
    assert len(spans) > 4
    assert not any(s.attrs["on_device"] for s in spans)


def test_device_apriori_gen_keeps_its_two_spans():
    """On a device, apriori_gen prunes the join's candidates where they lie:
    its ``mine.join`` span ends at the join, its ``mine.prune`` span brings
    the pruned candidates home, both marked ``on_device``."""
    prev = _canonical(_masks(_random_sets(5, 150, 3, n_items=9)))
    tr = Tracer()
    with use_tracer(tr):
        got = tc._apriori_gen_on(prev, 3, CPU)
    _same(got, tc.apriori_gen(prev, 3))
    join, prune = tr.spans
    assert (join.name, prune.name) == ("mine.join", "mine.prune")
    assert join.attrs == {"k": 4, "on_device": True, "n_in": prev.shape[0],
                          "n_out": prune.attrs["n_in"]}
    assert prune.attrs["n_out"] == got.shape[0] < prune.attrs["n_in"]
    assert join.t1 <= prune.t0
