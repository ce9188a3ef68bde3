"""The port's CUDA kernels and its mining path on a card.

Every test here needs a CUDA card and carries the ``gpu`` marker; without a
card each one skips, decided inside the ``cuda`` fixture when it runs.  The
file imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the same card
tensors, exactly: counts are integers, and the kernels' int32 atomics add in
any order to the same sum.
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import MapReduceRuntime, mine, sequential_apriori
from repro_torch.core.bitset import (pack_itemsets, to_device_words,
                                     vertical_pack)

pytestmark = pytest.mark.gpu

FAMILY_KERNEL = {"jnp": "support_count", "matmul": "support_count_matmul",
                 "vertical": "vertical_count",
                 "vertical_matmul": "vertical_count_matmul"}


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _horizontal_case(C, T, W, seed):
    rng = np.random.default_rng(seed)
    cands = rng.integers(0, 2**32, (C, W), dtype=np.uint32)
    txns = rng.integers(0, 2**32, (T, W), dtype=np.uint32)
    cands[0] = 0                      # empty candidate: counts every row
    txns[0] = 0xFFFFFFFF              # bit 31 set in every word
    if C > 1:
        cands[-1] = 0x80000000        # only bit 31 of each word
    return cands, txns


def _vertical_case(n_items, n, kmax, C, seed):
    rng = np.random.default_rng(seed)
    db = pack_itemsets(
        [sorted(rng.choice(n_items, rng.integers(0, min(12, n_items + 1)),
                           replace=False))
         for _ in range(n)], n_items)
    idx = np.full((C, kmax), n_items, np.int32)
    for i in range(C):
        k = rng.integers(0, kmax + 1)
        idx[i, :k] = rng.choice(n_items, k, replace=False)
    idx[C // 2, :] = n_items          # all-sentinel slots: the empty set
    if kmax > 1:
        idx[1, 1] = idx[1, 0]         # a duplicate slot
    return vertical_pack(db, n_items), idx


@pytest.mark.parametrize("C,T,W", [(1, 1, 1), (17, 33, 2), (300, 700, 8),
                                   (1000, 4099, 6), (33, 257, 3),
                                   (45, 600, 9), (300, 1025, 17)])
@pytest.mark.parametrize("name", ["support_count", "support_count_matmul"])
def test_horizontal_kernel_equals_plain(cuda, name, C, T, W):
    wrapper, plain = kernels.KERNELS[name]
    cands, txns = _horizontal_case(C, T, W, seed=C + T + W)
    c, t = to_device_words(cands, cuda), to_device_words(txns, cuda)
    before = kernels.LAUNCHES[name]
    got = wrapper(c, t)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    assert got.dtype == torch.int32 and got.shape == (C,)
    assert torch.equal(got, plain(c, t))
    cpu = plain(to_device_words(cands, "cpu"), to_device_words(txns, "cpu"))
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.parametrize("n_items,n,kmax,C", [(37, 101, 5, 23),
                                              (192, 5003, 4, 777),
                                              (5, 31, 1, 9)])
@pytest.mark.parametrize("name", ["vertical_count", "vertical_count_matmul"])
def test_vertical_kernel_equals_plain(cuda, name, n_items, n, kmax, C):
    wrapper, plain = kernels.KERNELS[name]
    vdb, idx = _vertical_case(n_items, n, kmax, C, seed=n + C)
    v, i = to_device_words(vdb, cuda), torch.from_numpy(idx).to(cuda)
    before = kernels.LAUNCHES[name]
    got = wrapper(v, i)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    assert torch.equal(got, plain(v, i))


def test_kernels_refuse_what_they_cannot_read(cuda):
    wide = torch.zeros((4, 9), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="word counts differ"):
        kernels.support_count(wide, wide[:, :8].contiguous())
    with pytest.raises(TypeError):
        kernels.support_count(wide.to(torch.int64), wide.to(torch.int64))
    with pytest.raises(ValueError, match="outside"):
        kernels.vertical_count(
            torch.zeros((4, 3), dtype=torch.int32, device=cuda),
            torch.tensor([[0, 4]], dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("family", sorted(FAMILY_KERNEL))
def test_mine_on_card_equals_cpu_and_oracle(cuda, family):
    rng = np.random.default_rng(7)
    txns = [sorted(set(rng.integers(0, 40, rng.integers(2, 12)).tolist()))
            for _ in range(500)]
    kernels.reset_launches()
    on_card = mine(txns, n_items=40, min_sup=0.1,
                   runtime=MapReduceRuntime(impl=family, device=cuda))
    assert kernels.LAUNCHES[FAMILY_KERNEL[family]] == on_card.dispatches > 0
    on_cpu = mine(txns, n_items=40, min_sup=0.1,
                  runtime=MapReduceRuntime(impl=family, device="cpu"))
    assert on_card.levels.keys() == on_cpu.levels.keys()
    for k, (masks, counts) in on_cpu.levels.items():
        np.testing.assert_array_equal(on_card.levels[k][0], masks)
        np.testing.assert_array_equal(on_card.levels[k][1], counts)
    assert on_card.itemsets() == sequential_apriori(txns, 0.1)


def test_default_device_is_the_card(cuda):
    rt = MapReduceRuntime()
    assert rt.device.type == "cuda" and rt.impl == "vertical"
    db = pack_itemsets([[0, 1], [1, 2], [0, 1, 2]], 3)
    vdb = rt.scatter_db(db, n_items=3)
    fut = rt.phase_count_async(vdb, pack_itemsets([[0, 1], [2], []], 3))
    assert fut.result().tolist() == [2, 2, 3]
    assert fut.ready()


# -- streaming and serving kernels (kernels 5–8) ---------------------------------

def _signed_case(C, T, W, seed):
    cands, txns = _horizontal_case(C, T, W, seed)
    rng = np.random.default_rng(seed + 1)
    cands &= rng.integers(0, 2**32, (C, W), dtype=np.uint32)
    signs = rng.integers(-1, 2, T).astype(np.int32)
    return cands, txns, signs


@pytest.mark.parametrize("C,T,W", [(1, 1, 1), (17, 33, 2), (300, 700, 8),
                                   (1000, 4099, 6), (28672, 512, 4),
                                   (45, 600, 9), (300, 1025, 17)])
@pytest.mark.parametrize("name", ["delta_count", "delta_count_matmul"])
def test_delta_kernel_equals_plain(cuda, name, C, T, W):
    wrapper, plain = kernels.KERNELS[name]
    cands, txns, signs = _signed_case(C, T, W, seed=C + T + W)
    args = (to_device_words(cands, cuda), to_device_words(txns, cuda),
            torch.from_numpy(signs).to(cuda))
    before = kernels.LAUNCHES[name]
    got = wrapper(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    assert got.dtype == torch.int32 and got.shape == (C,)
    assert torch.equal(got, plain(*args))
    cpu = plain(*(a.cpu() for a in args))
    assert torch.equal(got.cpu(), cpu)


def _rule_case(R, Q, W, seed):
    rng = np.random.default_rng(seed)

    def sparse(n):
        return (rng.integers(0, 2**32, (n, W), dtype=np.uint32)
                & rng.integers(0, 2**32, (n, W), dtype=np.uint32)
                & rng.integers(0, 2**32, (n, W), dtype=np.uint32))
    ante, cons, baskets = sparse(R), sparse(R), ~sparse(Q)
    ante[-1] = 0
    scores = rng.random(R).astype(np.float32)
    scores[0] = np.inf
    return ante, cons, scores, baskets


@pytest.mark.parametrize("R,Q,W", [(1, 1, 1), (37, 13, 2), (700, 70, 4),
                                   (1000, 45, 9), (4099, 129, 3)])
@pytest.mark.parametrize("exclude", [True, False])
@pytest.mark.parametrize("name", ["rule_scores", "rule_scores_matmul"])
def test_rule_kernel_equals_plain(cuda, name, R, Q, W, exclude):
    """Float32 score bits, -inf no-match slots and +inf scores included."""
    wrapper, plain = kernels.KERNELS[name]
    ante, cons, scores, baskets = _rule_case(R, Q, W, seed=R + Q + W)
    args = (to_device_words(ante, cuda), to_device_words(cons, cuda),
            torch.from_numpy(scores).to(cuda),
            to_device_words(baskets, cuda), exclude)
    before = kernels.LAUNCHES[name]
    got = wrapper(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    assert got.dtype == torch.float32 and got.shape == (Q, R)
    want = plain(*args)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if R > 1:     # one rule, with an empty antecedent, fires everywhere
        assert torch.isneginf(got).any() and torch.isfinite(got).any()


def _tenant_rules():
    from repro_torch.core import generate_ruleset
    out, baskets = {}, {}
    for i, seed in enumerate((3, 4)):
        rng = np.random.default_rng(seed)
        base = rng.random((3, 40)) < 0.4
        txns = []
        for _ in range(300):
            pat = base[rng.integers(3)]
            row = np.where(rng.random(40) < 0.85, pat, rng.random(40) < 0.1)
            txns.append(np.nonzero(row)[0].tolist() or [0])
        res = mine(txns, n_items=40, min_sup=0.25, device="cpu")
        out[f"t{i}"] = generate_ruleset(res, 0.6, device="cpu")
        baskets[f"t{i}"] = [t[:-1] for t in txns[:64]]
    return out, baskets


@pytest.mark.parametrize("impl", ["jnp", "matmul"])
def test_serving_on_card_equals_cpu(cuda, impl):
    from repro_torch.serving import RuleServeEngine, RuleStore
    tenants, baskets = _tenant_rules()
    queries = [(t, b) for pair in zip(*[[(t, b) for b in baskets[t]]
                                        for t in tenants]) for t, b in pair]
    batches = [queries[i:i + 8] for i in range(0, len(queries), 8)]
    name = {"jnp": "rule_scores", "matmul": "rule_scores_matmul"}[impl]
    on_card = RuleServeEngine(RuleStore(tenants=tenants, device=cuda),
                              impl=impl, top_k=4, device=cuda)
    kernels.reset_launches()
    got, records = on_card.serve(batches)
    assert kernels.LAUNCHES[name] == len(records) > 0
    on_cpu = RuleServeEngine(RuleStore(tenants=tenants, device="cpu"),
                             impl=impl, top_k=4, device="cpu")
    assert got == on_cpu.serve(batches)[0]
    assert any(recs for batch in got for recs in batch)


def test_window_ring_write_on_card(cuda):
    from repro_torch.stream import TransactionWindow
    rng = np.random.default_rng(5)
    txns = [sorted(set(rng.integers(0, 70, rng.integers(1, 9)).tolist()))
            for _ in range(300)]
    w = TransactionWindow(70, capacity=100, device=cuda)
    for lo, hi in ((0, 100), (100, 140), (140, 141), (141, 300)):
        w.append(txns[lo:hi])
        w.evict(3)
        ring = w.device_masks()
        assert ring.device.type == "cuda" and ring.dtype == torch.int32
        host = np.zeros((w.capacity, w.W), np.uint32)
        host[(w._start + np.arange(w.size)) % w.capacity] = w.contents()
        np.testing.assert_array_equal(ring.cpu().numpy().view(np.uint32),
                                      host)


def _wide_txns(n, n_items, rng):
    """Sparse baskets over more than 256 items: two patterns past item 256."""
    base = [[3, 70, 255, 256, 280, n_items - 1], [5, 129, 257, 290, 291]]
    return [sorted({i for i in base[rng.integers(2)] if rng.random() < 0.85}
                   | set(rng.integers(0, n_items, 2).tolist()))
            for _ in range(n)]


@pytest.mark.parametrize("n_items", [20, 300])
@pytest.mark.parametrize("impl", ["jnp", "matmul"])
def test_stream_on_card_equals_scratch(cuda, impl, n_items):
    """20 items: W = 1; 300 items: W = 10, the counting kernels' chunked
    instance."""
    from repro_torch.stream import StreamMiner, levels_equal
    rng = np.random.default_rng(8)
    if n_items > 256:
        txns = _wide_txns(400, n_items, rng)
    else:
        base = rng.random((3, n_items)) < 0.5
        txns = []
        for _ in range(400):
            pat = base[rng.integers(3)]
            row = np.where(rng.random(n_items) < 0.85, pat,
                           rng.random(n_items) < 0.1)
            txns.append(np.nonzero(row)[0].tolist() or [0])
    name = {"jnp": "delta_count", "matmul": "delta_count_matmul"}[impl]
    miner = StreamMiner(n_items, 0.3, capacity=128, impl=impl,
                        staleness_factor=1e9, device=cuda)
    kernels.reset_launches()
    for lo in range(0, 400, 40):
        miner.push(txns[lo:lo + 40])
        scratch = mine(db_masks=miner.window.contents(), n_items=n_items,
                       min_sup=0.3, runtime=MapReduceRuntime(device=cuda))
        assert levels_equal(miner.levels, scratch.levels)
    assert kernels.LAUNCHES[name] == sum(u.path != "remine"
                                         for u in miner.updates) > 0
