"""The port's counting kernels against the JAX package's.

On the CPU each wrapper runs its kernel's plain PyTorch version; those are
held here, exactly (counts are integers), against the reference's jnp form
and its Pallas kernel in interpret mode, on the ``test_kernels.py`` cases:
ragged tails, W > 1, empty candidates, zero padding, and duplicate and
sentinel slots for the vertical forms.  The CUDA kernels themselves run only
on a card: ``test_torch_gpu.py`` holds each one against its plain version
there.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypothesis_compat import given, settings, st

from repro.core.bitset import pack_itemsets, vertical_pack
from repro.kernels import support_count as ref_support_count
from repro.kernels.vertical_count import (vertical_count_jnp,
                                          vertical_count_matmul,
                                          vertical_count_matmul_pallas,
                                          vertical_count_pallas)
from repro_torch import kernels
from repro_torch.core.bitset import to_device_words

# the package re-exports functions under the names of these modules
sc = importlib.import_module("repro_torch.kernels.support_count")
vc = importlib.import_module("repro_torch.kernels.vertical_count")

HORIZONTAL_SHAPES = [(1, 1, 1), (3, 5, 1), (17, 33, 2), (64, 128, 3),
                     (256, 512, 6), (300, 700, 8), (256, 512, 1),
                     # the card kernel's tile edges (128 candidates, 128
                     # transactions) and K past 256 planes (W = 9, 17)
                     (63, 127, 3), (65, 257, 6), (129, 257, 9),
                     (129, 127, 17),
                     # support_count's tiles: 256 candidates, 128
                     # transactions, 256 bits a K chunk
                     (257, 129, 1), (257, 383, 8), (513, 129, 9)]

# port family → the reference impls it must equal
HORIZONTAL_FAMILIES = {
    "support_count": (sc.support_count, sc.support_count_plain,
                      ("jnp", "pallas_interpret")),
    "support_count_matmul": (sc.support_count_matmul,
                             sc.support_count_matmul_plain,
                             ("matmul", "matmul_pallas_interpret")),
}


def _horizontal_case(C, T, W):
    rng = np.random.default_rng(C * 1000 + T + W)
    cands = rng.integers(0, 2**32, (C, W), dtype=np.uint32)
    txns = rng.integers(0, 2**32, (T, W), dtype=np.uint32)
    cands[0] = 0                      # empty candidate: counts every row
    if C > 1:
        cands[-1] &= txns[0]          # contained in at least one row
    return cands, txns


def _high_hit_case(C, T, W):
    """Sparse candidates of 1-3 bits against dense rows (each bit set with
    probability 0.8): most counts are non-zero and many distinct, so a
    compare that is wrong at one position shows."""
    rng = np.random.default_rng(C * 1000 + T + W + 7)
    cands = np.zeros((C, W), np.uint32)
    for i in range(C):
        for b in rng.choice(32 * W, rng.integers(1, 4), replace=False):
            cands[i, b // 32] |= np.uint32(1 << (b % 32))
    dense = rng.random((T, 32 * W)) < 0.8
    txns = np.packbits(dense, axis=1, bitorder="little").view(np.uint32)
    return cands, txns.reshape(T, W)


def _words(a):
    return to_device_words(a, "cpu")


@pytest.mark.parametrize("C,T,W", HORIZONTAL_SHAPES)
@pytest.mark.parametrize("name", sorted(HORIZONTAL_FAMILIES))
def test_horizontal_plain_matches_reference(name, C, T, W):
    wrapper, plain, ref_impls = HORIZONTAL_FAMILIES[name]
    cands, txns = _horizontal_case(C, T, W)
    want = np.asarray(ref_support_count(cands, txns, impl=ref_impls[0]))
    np.testing.assert_array_equal(
        np.asarray(ref_support_count(cands, txns, impl=ref_impls[1])), want)
    np.testing.assert_array_equal(plain(_words(cands), _words(txns)).numpy(),
                                  want)
    np.testing.assert_array_equal(wrapper(_words(cands), _words(txns)).numpy(),
                                  want)


@pytest.mark.parametrize("C,T,W", [(65, 257, 6), (129, 127, 9),
                                   (63, 300, 17), (257, 1025, 1),
                                   (257, 383, 8)])
@pytest.mark.parametrize("name", sorted(HORIZONTAL_FAMILIES))
def test_horizontal_plain_matches_reference_high_hit(name, C, T, W):
    wrapper, plain, ref_impls = HORIZONTAL_FAMILIES[name]
    cands, txns = _high_hit_case(C, T, W)
    want = np.asarray(ref_support_count(cands, txns, impl=ref_impls[0]))
    assert (want > 0).all() and len(set(want.tolist())) > C // 4
    np.testing.assert_array_equal(
        np.asarray(ref_support_count(cands, txns, impl=ref_impls[1])), want)
    np.testing.assert_array_equal(plain(_words(cands), _words(txns)).numpy(),
                                  want)
    np.testing.assert_array_equal(wrapper(_words(cands), _words(txns)).numpy(),
                                  want)


@pytest.mark.parametrize("impl", ["jnp", "matmul"])
def test_host_entry_point_matches_reference(impl):
    cands, txns = _horizontal_case(37, 91, 3)
    np.testing.assert_array_equal(
        kernels.support_count_host(cands, txns, impl=impl, device="cpu"),
        np.asarray(ref_support_count(cands, txns, impl=impl)))


def test_zero_padding_safety():
    """Zero transaction rows never match non-empty candidates; the empty
    candidate matches every row, zero rows included — as in the reference."""
    cands = pack_itemsets([[0], []], 32)
    txns = np.concatenate([pack_itemsets([[0], [1]], 32),
                           np.zeros((5, 1), np.uint32)])
    for name, (wrapper, plain, ref_impls) in HORIZONTAL_FAMILIES.items():
        for impl in ref_impls:
            np.testing.assert_array_equal(
                np.asarray(ref_support_count(cands, txns, impl=impl)), [1, 7])
        for fn in (wrapper, plain):
            np.testing.assert_array_equal(
                fn(_words(cands), _words(txns)).numpy(), [1, 7], err_msg=name)


@pytest.mark.parametrize("block", [1, 7, 64, 4096])
def test_plain_versions_do_not_depend_on_block(block):
    cands, txns = _horizontal_case(37, 101, 2)
    want = np.asarray(ref_support_count(cands, txns, impl="jnp"))
    c, t = _words(cands), _words(txns)
    np.testing.assert_array_equal(sc.support_count_plain(c, t, block).numpy(),
                                  want)
    np.testing.assert_array_equal(
        sc.support_count_matmul_plain(c, t, block).numpy(), want)
    vdb, idx = _random_vertical(np.random.default_rng(block))
    vwant = np.asarray(vertical_count_jnp(jnp.asarray(vdb), jnp.asarray(idx)))
    v, i = _words(vdb), torch.from_numpy(idx)
    np.testing.assert_array_equal(vc.vertical_count_plain(v, i, block).numpy(),
                                  vwant)
    np.testing.assert_array_equal(
        vc.vertical_count_matmul_plain(v, i, block).numpy(), vwant)


@given(st.lists(st.lists(st.integers(0, 60), min_size=0, max_size=10)
                .map(lambda x: sorted(set(x))), min_size=1, max_size=20),
       st.lists(st.lists(st.integers(0, 60), min_size=0, max_size=20)
                .map(lambda x: sorted(set(x))), min_size=1, max_size=30))
@settings(max_examples=25, deadline=None)
def test_plain_versions_are_subset_counts(cand_sets, txn_sets):
    cands = _words(pack_itemsets(cand_sets, 61))
    txns = _words(pack_itemsets(txn_sets, 61))
    want = [sum(1 for t in txn_sets if set(cs) <= set(t)) for cs in cand_sets]
    assert sc.support_count_plain(cands, txns).tolist() == want
    assert sc.support_count_matmul_plain(cands, txns).tolist() == want


# -- vertical forms --------------------------------------------------------------

def _random_vertical(rng, n_items=37, n=101, kmax=5, C=23, dense=False):
    """Sparse rows (up to 7 items) or, ``dense``, each item with probability
    0.8 — then most candidates are contained in many rows."""
    if dense:
        rows = [np.nonzero(rng.random(n_items) < 0.8)[0] for _ in range(n)]
    else:
        rows = [sorted(rng.choice(n_items, rng.integers(0, min(8, n_items + 1)),
                                  replace=False))
                for _ in range(n)]
    db = pack_itemsets(rows, n_items)
    vdb = vertical_pack(db, n_items)
    idx = np.full((C, kmax), n_items, np.int32)
    for i in range(C):
        k = rng.integers(0, kmax + 1)
        idx[i, :k] = rng.choice(n_items, k, replace=False)
    idx[C // 2, :] = n_items         # all-padding candidate (empty set)
    return vdb, idx


VERTICAL_CASES = [  # (seed, n_items, n_txns, kmax, C)
    (11, 37, 101, 5, 23), (12, 37, 101, 5, 23), (13, 70, 1000, 3, 64),
    (14, 192, 333, 4, 17), (15, 5, 31, 1, 9),
    # K not a multiple of 32 (37, 119 items) and past 256 (300), at the
    # card kernel's tile edges
    (16, 37, 257, 3, 65), (17, 119, 127, 3, 129), (18, 300, 257, 4, 63)]


def _vertical_reference(vdb, idx):
    """Every reference form, which must agree with each other; returns the
    jnp oracle's counts."""
    v, i = jnp.asarray(vdb), jnp.asarray(idx)
    want = np.asarray(vertical_count_jnp(v, i))
    others = {
        "pallas_interpret": vertical_count_pallas(v, i, bt=128,
                                                  interpret=True),
        "matmul": vertical_count_matmul(v, i, block=8),
        "matmul_pallas_interpret": vertical_count_matmul_pallas(
            v, i, bc=8, bt=64, interpret=True),
    }
    for name, got in others.items():
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=name)
    return want


@pytest.mark.parametrize("case", VERTICAL_CASES)
@pytest.mark.parametrize("duplicate", [False, True])
def test_vertical_plain_matches_reference(case, duplicate):
    seed, n_items, n, kmax, C = case
    vdb, idx = _random_vertical(np.random.default_rng(seed), n_items, n,
                                kmax, C)
    if duplicate and kmax > 1:
        idx[1, 1] = idx[1, 0]        # a repeated item id stays AND-idempotent
        idx[2, :] = idx[2, 0]
    want = _vertical_reference(vdb, idx)
    v, i = _words(vdb), torch.from_numpy(idx)
    for fn in (vc.vertical_count_plain, vc.vertical_count,
               vc.vertical_count_matmul_plain, vc.vertical_count_matmul):
        np.testing.assert_array_equal(fn(v, i).numpy(), want,
                                      err_msg=fn.__name__)


@pytest.mark.parametrize("n_items,n,kmax,C", [(37, 257, 3, 65),
                                              (119, 127, 3, 129),
                                              (300, 300, 3, 63)])
def test_vertical_plain_matches_reference_high_hit(n_items, n, kmax, C):
    vdb, idx = _random_vertical(np.random.default_rng(n_items + n), n_items,
                                n, kmax, C, dense=True)
    want = _vertical_reference(vdb, idx)
    assert (want > 0).all() and len(set(want.tolist())) > C // 4
    v, i = _words(vdb), torch.from_numpy(idx)
    for fn in (vc.vertical_count_matmul_plain, vc.vertical_count_matmul):
        np.testing.assert_array_equal(fn(v, i).numpy(), want,
                                      err_msg=fn.__name__)


# past the card kernel's 32-word tiles: 800 items (16-word tiles), 1,800
# (8-word tiles at one block an SM) and 4,000 (its L2 instance), each with
# a ragged last word of transactions
@pytest.mark.parametrize("n_items,n,kmax,C", [(800, 530, 3, 40),
                                              (1800, 250, 3, 33),
                                              (1800, 290, 5, 24),
                                              (4000, 333, 3, 17)])
def test_vertical_plain_matches_reference_at_many_items(n_items, n, kmax, C):
    vdb, idx = _random_vertical(np.random.default_rng(n_items + n), n_items,
                                n, kmax, C)
    idx[1, 1] = idx[1, 0]            # a duplicate slot
    assert n % 32 and vdb.shape == (n_items + 1, -(-n // 32))
    want = _vertical_reference(vdb, idx)
    v, i = _words(vdb), torch.from_numpy(idx)
    for fn in (vc.vertical_count_plain, vc.vertical_count):
        np.testing.assert_array_equal(fn(v, i).numpy(), want,
                                      err_msg=fn.__name__)


def test_vertical_membership_collapses_duplicates_and_sentinels():
    idx = torch.tensor([[0, 0, 3], [3, 3, 3], [2, 1, 3]], dtype=torch.int32)
    A, nreal = vc.vertical_membership(idx, 3, n_cols=8)
    assert A.shape == (3, 8) and A.dtype == torch.int8
    assert A.tolist() == [[1, 0, 0, 0, 0, 0, 0, 0], [0] * 8,
                          [0, 1, 1, 0, 0, 0, 0, 0]]
    assert nreal.tolist() == [1, 0, 2]


# -- wrapper checks and launch counts --------------------------------------------

def _matmul_plain_args(name):
    cands, txns = _horizontal_case(17, 33, 2)
    if name == "vertical_count_matmul":
        vdb, idx = _random_vertical(np.random.default_rng(1))
        return _words(vdb), torch.from_numpy(idx)
    if name == "delta_count_matmul":
        return (_words(cands), _words(txns),
                torch.from_numpy(np.resize(np.int32([1, -1, 0]), 33)))
    if name == "rule_scores_matmul":
        return _words(cands), _words(cands), torch.ones(17), _words(txns)
    return _words(cands), _words(txns)


@pytest.mark.parametrize("before", [True, False])
@pytest.mark.parametrize("name", ["support_count_matmul",
                                  "vertical_count_matmul",
                                  "delta_count_matmul", "rule_scores_matmul"])
def test_plain_matmul_versions_leave_the_tf32_flag(name, before):
    """Each runs its products in full float32 and leaves the process-wide
    TF32 flag as it found it, as the reference's plain versions change no
    global state."""
    plain = kernels.KERNELS[name][1]
    flag = torch.backends.cuda.matmul
    saved = flag.allow_tf32
    try:
        flag.allow_tf32 = before
        plain(*_matmul_plain_args(name))
        assert flag.allow_tf32 is before
    finally:
        flag.allow_tf32 = saved


def _cpu_args(name):
    """CPU arguments of each kernel's wrapper, by its family."""
    cands, txns = _horizontal_case(17, 33, 2)
    if name.startswith("candidate"):
        # a canonical level of 2-itemsets over 40 items, and its join
        level = pack_itemsets([[i, j] for j in range(1, 40, 3)
                               for i in range(0, j, 5)], 40)
        level = _words(level[np.lexsort(level.T)])
        if name == "candidate_join":
            return (level,)
        return kernels.join_words_plain(level, parents=False)[0], level
    if name.startswith("support"):
        return _words(cands), _words(txns)
    if name.startswith("delta"):
        signs = np.resize(np.array([1, -1, 0], np.int32), 33)
        return _words(cands), _words(txns), torch.from_numpy(signs)
    if name.startswith("rule"):
        return (_words(cands), _words(cands), torch.ones(17),
                _words(txns), True)
    vdb, idx = _random_vertical(np.random.default_rng(0))
    return _words(vdb), torch.from_numpy(idx)


def test_wrappers_on_cpu_launch_nothing():
    kernels.reset_launches()
    for name, (wrapper, _plain) in kernels.KERNELS.items():
        wrapper(*_cpu_args(name))
    assert all(n == 0 for n in kernels.LAUNCHES.values())
    assert sorted(kernels.LAUNCHES) == sorted(kernels.KERNELS)


def test_check_words_rejects_what_a_kernel_cannot_read():
    t = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(TypeError):
        sc.check_words("t", t.to(torch.int64), t.device)
    with pytest.raises(ValueError, match="contiguous"):
        sc.check_words("t", t.T, t.device)
    with pytest.raises(ValueError, match="dims"):
        sc.check_words("t", t[0], t.device)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sc.check_words("t", t, t.device)            # a kernel needs a card
    # tensors on neither the CPU nor a card reach no plain version
    for name, (wrapper, _plain) in kernels.KERNELS.items():
        meta = [a.to("meta") if isinstance(a, torch.Tensor) else a
                for a in _cpu_args(name)]
        with pytest.raises(ValueError, match="CUDA tensors"):
            wrapper(*meta)
