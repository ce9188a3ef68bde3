"""The port's CUDA kernels and its mining path on a card.

Every test here needs a CUDA card and carries the ``gpu`` marker; without a
card each one skips, decided inside the ``cuda`` fixture when it runs.  The
file imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the same card
tensors, exactly: counts are integers, and the kernels' int32 atomics add in
any order to the same sum.  The LM decoder (plain torch, no kernel of the
port) is held against its CPU run within the CPU tests' tolerances, and
full-config smollm-135m serving against its own ``spc`` tokens; so are the
MoE, SSM, hybrid, encoder-decoder and VLM families at their smoke configs,
and mamba2-370m at its full config.
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


@pytest.fixture(autouse=True)
def fresh_autotune_cache(tmp_path, monkeypatch):
    """A fresh plan cache for every test: ``impl="auto"`` sweeps on the
    card, and a plan cached by an earlier run would skip the sweep."""
    from repro_torch.kernels import autotune
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    monkeypatch.setattr(autotune, "_memory_cache", {})


def _horizontal_case(C, T, W, seed):
    rng = np.random.default_rng(seed)
    cands = rng.integers(0, 2**32, (C, W), dtype=np.uint32)
    txns = rng.integers(0, 2**32, (T, W), dtype=np.uint32)
    cands[0] = 0                      # empty candidate: counts every row
    txns[0] = 0xFFFFFFFF              # bit 31 set in every word
    if C > 1:
        cands[-1] = 0x80000000        # only bit 31 of each word
    return cands, txns


def _high_hit_case(C, T, W, seed):
    """Sparse candidates of 1-3 bits against dense rows (each bit set with
    probability 0.8): most counts are non-zero and many distinct, so a
    compare or weight that is wrong at one fragment position shows."""
    rng = np.random.default_rng(seed)
    cands = np.zeros((C, W), np.uint32)
    for i in range(C):
        for b in rng.choice(32 * W, rng.integers(1, 4), replace=False):
            cands[i, b // 32] |= np.uint32(1 << (b % 32))
    dense = rng.random((T, 32 * W)) < 0.8
    txns = np.packbits(dense, axis=1, bitorder="little").view(np.uint32)
    return cands, txns.reshape(T, W)


def _vertical_case(n_items, n, kmax, C, seed, dense=False):
    rng = np.random.default_rng(seed)
    if dense:       # each item with probability 0.8: most counts non-zero
        rows = [np.nonzero(rng.random(n_items) < 0.8)[0] for _ in range(n)]
    else:
        rows = [sorted(rng.choice(n_items,
                                  rng.integers(0, min(12, n_items + 1)),
                                  replace=False))
                for _ in range(n)]
    db = pack_itemsets(rows, n_items)
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
                                   (45, 600, 9), (300, 1025, 17),
                                   # tile edges of the tensor-core kernel
                                   # (256 candidates × 128 transactions)
                                   (63, 127, 3), (65, 257, 6),
                                   (129, 257, 9), (129, 127, 17),
                                   (257, 129, 1), (257, 383, 8),
                                   (513, 129, 9)])
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
                                              (5, 31, 1, 9),
                                              # K = 37 and 119 (not whole
                                              # k-steps), 300 (two chunks)
                                              (37, 257, 3, 65),
                                              (119, 127, 3, 129),
                                              (300, 4099, 4, 257)])
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


@pytest.mark.parametrize("C,T,W", [(65, 257, 6), (129, 127, 9),
                                   (257, 1000, 17), (2000, 3000, 6),
                                   (257, 1025, 1), (513, 383, 8)])
@pytest.mark.parametrize("name", ["support_count", "support_count_matmul"])
def test_matmul_kernel_high_hit(cuda, name, C, T, W):
    """Most counts non-zero and distinct: every fragment position counts,
    in both tensor-core kernels (single bits and int8 planes)."""
    wrapper, plain = kernels.KERNELS[name]
    cands, txns = _high_hit_case(C, T, W, seed=C + T + W)
    c, t = to_device_words(cands, cuda), to_device_words(txns, cuda)
    got = wrapper(c, t)
    want = plain(c, t)
    assert (want > 0).all() and len(set(want.tolist())) > min(C // 4, 100)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_items,n,kmax,C", [(37, 1000, 3, 65),
                                              (119, 2000, 3, 129),
                                              (300, 700, 3, 63),
                                              (192, 5003, 2, 777)])
def test_vertical_matmul_kernel_high_hit(cuda, n_items, n, kmax, C):
    wrapper, plain = kernels.KERNELS["vertical_count_matmul"]
    vdb, idx = _vertical_case(n_items, n, kmax, C, seed=n + C, dense=True)
    v, i = to_device_words(vdb, cuda), torch.from_numpy(idx).to(cuda)
    got = wrapper(v, i)
    want = plain(v, i)
    assert (want > 0).all() and len(set(want.tolist())) > min(C // 4, 100)
    assert torch.equal(got, want)


# vertical_count's tiled instances (1,024 candidates a block; tiles of 32
# words at 192 items, 16 at 800, 8 at 1,800) and its L2 instance (past
# 3,227 items or 8 slots): Tw of 31, 32, 33 and 65 words and ragged at the
# narrower tiles, C of 1,023-1,025 and 2,049, kmax 1, 5 and 9
VERTICAL_TILE_CASES = [(192, 990, 3, 1023), (192, 1024, 3, 1024),
                       (192, 1040, 3, 1025), (192, 5003, 1, 1025),
                       (192, 2080, 5, 2049), (192, 3000, 9, 300),
                       (800, 530, 3, 300), (1800, 250, 3, 1025),
                       (1800, 290, 5, 700), (4000, 1000, 3, 500)]


@pytest.mark.parametrize("n_items,n,kmax,C", VERTICAL_TILE_CASES)
def test_vertical_count_tiles(cuda, n_items, n, kmax, C):
    wrapper, plain = kernels.KERNELS["vertical_count"]
    vdb, idx = _vertical_case(n_items, n, kmax, C, seed=n_items + n + C)
    v, i = to_device_words(vdb, cuda), torch.from_numpy(idx).to(cuda)
    before = kernels.LAUNCHES["vertical_count"]
    got = wrapper(v, i)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["vertical_count"] == before + 1
    assert torch.equal(got, plain(v, i))
    cpu = plain(to_device_words(vdb, "cpu"), torch.from_numpy(idx))
    assert torch.equal(got.cpu(), cpu)


def test_vertical_count_more_chunks_than_blocks(cuda):
    """600,000 candidates: more chunks than resident blocks, so each block
    walks every tile and stores its counts (no atomics)."""
    rng = np.random.default_rng(9)
    vdb, _ = _vertical_case(37, 2000, 2, 4, seed=9)
    idx = rng.integers(0, 38, (600_000, 2)).astype(np.int32)
    v, i = to_device_words(vdb, cuda), torch.from_numpy(idx).to(cuda)
    got = kernels.vertical_count(v, i)
    assert torch.equal(got, kernels.vertical_count_plain(v, i))
    assert torch.equal(got.cpu(), kernels.vertical_count_plain(
        to_device_words(vdb, "cpu"), torch.from_numpy(idx)))


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


def _weighted_case(C, T, W, signs, seed):
    """High-hit words (sparse candidates, every fourth empty, against dense
    rows) and the slab's signs drawn from ``signs``, or ``"tiles"``: +1 rows
    then -1 rows, 128-row tiles of one weight as a streaming slab has."""
    rng = np.random.default_rng(seed)
    cands, txns = _high_hit_case(C, T, W, seed)
    cands[::4] = 0
    if signs == "tiles":
        sign = np.where(np.arange(T) < T // 2, 1, -1).astype(np.int32)
    else:
        sign = rng.choice(np.asarray(signs, np.int32), T)
    return cands, txns, sign


# the tensor-core kernel's tile edges (C of 255-257, T of 127-129) and K
# steps (W of 1, 8, 9 and 17); signs of {-1, 0, 1}, all zero, outside
# {-1, 0, 1}, and tiles of one weight (ragged: T = 200)
@pytest.mark.parametrize("C,T,W,signs", [
    (255, 127, 1, (-1, 0, 1)), (256, 128, 8, (-1, 0, 1)),
    (257, 129, 9, (-1, 0, 1)), (257, 383, 17, (-3, 0, 7)),
    (300, 1025, 4, (0,)), (513, 257, 4, (-3, 3, 7)),
    (2000, 512, 4, "tiles"), (65, 200, 2, "tiles"), (255, 256, 1, (7,))])
@pytest.mark.parametrize("name", ["delta_count", "delta_count_matmul"])
def test_delta_kernel_weights(cuda, name, C, T, W, signs):
    wrapper, plain = kernels.KERNELS[name]
    cands, txns, sign = _weighted_case(C, T, W, signs, seed=C + T + W)
    args = (to_device_words(cands, cuda), to_device_words(txns, cuda),
            torch.from_numpy(sign).to(cuda))
    got = wrapper(*args)
    want = plain(*args)
    assert torch.equal(got, want)
    assert (want[::4] == int(sign.sum())).all()   # the empty candidates
    assert torch.equal(got.cpu(), plain(*(a.cpu() for a in args)))


# delta_count's register instances: slabs past one staged tile of 512
# rows, C off its blocks of 256, 128, 64 and 32 candidates (and the
# streaming shape's C + 1), all-zero signs, weights -3 and 7, W of 1, 4, 8
# and 9 (the chunked instance)
@pytest.mark.parametrize("C,T,W,signs", [
    (1000, 513, 4, (-1, 0, 1)), (300, 1100, 8, (-3, 7)),
    (777, 4099, 1, (-1, 0, 1)), (100, 4099, 4, (-3, 7)),
    (1001, 600, 1, (0,)), (28673, 512, 4, (-1, 0, 1)),
    (300, 600, 9, (-3, 7))])
def test_delta_count_slab_tiles(cuda, C, T, W, signs):
    wrapper, plain = kernels.KERNELS["delta_count"]
    cands, txns, sign = _weighted_case(C, T, W, signs, seed=C + T + W)
    args = (to_device_words(cands, cuda), to_device_words(txns, cuda),
            torch.from_numpy(sign).to(cuda))
    before = kernels.LAUNCHES["delta_count"]
    got = wrapper(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["delta_count"] == before + 1
    assert torch.equal(got, plain(*args))
    assert torch.equal(got.cpu(), plain(*(a.cpu() for a in args)))


def _rule_case(R, Q, W, seed):
    rng = np.random.default_rng(seed)

    def sparse(n):
        return (rng.integers(0, 2**32, (n, W), dtype=np.uint32)
                & rng.integers(0, 2**32, (n, W), dtype=np.uint32)
                & rng.integers(0, 2**32, (n, W), dtype=np.uint32))
    ante, cons, baskets = sparse(R), sparse(R), ~sparse(Q)
    for r in range(1, min(R, 9)):     # held by basket r % Q, with and
        ante[r] &= baskets[r % Q]     # without the consequent
        cons[r] &= baskets[r % Q] if r % 2 else ~baskets[r % Q]
    if R > 2:
        cons[-2] = 0                  # an empty consequent never fires
    ante[-1] = 0
    scores = rng.random(R).astype(np.float32)
    scores[0] = np.inf
    return ante, cons, scores, baskets


# R off the 128- and 512-rule tiles and R ≡ 1, 2, 3 (mod 4), every row
# alignment; Q of 1, 33 (half an M tile), 63, 64, 65 and 512
@pytest.mark.parametrize("R,Q,W", [(1, 1, 1), (37, 13, 2), (700, 70, 4),
                                   (1000, 45, 9), (4099, 129, 3),
                                   (300, 33, 1), (129, 512, 4), (1000, 1, 9),
                                   (257, 33, 4), (43694, 512, 4),
                                   (4097, 63, 4), (4098, 64, 4),
                                   (4099, 65, 4), (1001, 65, 9),
                                   (1002, 63, 17), (1003, 64, 1)])
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


# -- the autotuner's cross-family plans on the card --------------------------------

PLAN_KERNELS = {
    "count": FAMILY_KERNEL,
    "delta": {"delta_jnp": "delta_count", "delta_matmul": "delta_count_matmul"},
    "rules": {"rules_jnp": "rule_scores", "rules_matmul": "rule_scores_matmul"},
}


@pytest.fixture
def fresh_costmodel(tmp_path, monkeypatch):
    """An empty cost model, so no calibrated fit prunes a family."""
    import repro_torch.costmodel.model as cm
    monkeypatch.setenv("REPRO_TORCH_COSTMODEL_CACHE", str(tmp_path / "cm.json"))
    monkeypatch.setattr(cm, "_default", None)


@pytest.mark.parametrize("kind,shape", [
    ("count", dict(C=256, T=2048, W=4, kmax=8)),
    ("count", dict(C=3072, T=200000, W=6, kmax=4)),
    ("delta", dict(C=1000, T=512, W=4)),
    ("rules", dict(C=3000, T=256, W=4)),
])
def test_plan_real_sweep_on_the_card(cuda, fresh_costmodel, kind, shape):
    """Real timings: every family of the kind runs its kernel, and the
    winner is the fastest family it timed; a second call is a cache hit."""
    from repro_torch.kernels.autotune import PLAN_FAMILIES, tuned_plan
    kernels.reset_launches()
    plan = tuned_plan(kind, device=cuda, **shape)
    assert plan is not None
    assert set(plan["timed_us"]) == set(PLAN_FAMILIES[kind])
    assert plan["timed_us"][plan["family"]] == min(plan["timed_us"].values())
    for name in PLAN_KERNELS[kind].values():
        assert kernels.LAUNCHES[name] > 0, name
    kernels.reset_launches()
    assert tuned_plan(kind, device=cuda, **shape) == plan
    assert not any(kernels.LAUNCHES.values())


def test_mine_auto_on_card_equals_every_family(cuda):
    rng = np.random.default_rng(9)
    txns = [sorted(set(rng.integers(0, 40, rng.integers(2, 12)).tolist()))
            for _ in range(3000)]
    rt = MapReduceRuntime(device=cuda)
    auto = mine(txns, n_items=40, min_sup=0.05, runtime=rt)
    assert rt.impl in FAMILY_KERNEL
    for family in FAMILY_KERNEL:
        fixed = mine(txns, n_items=40, min_sup=0.05,
                     runtime=MapReduceRuntime(impl=family, device=cuda))
        assert auto.levels.keys() == fixed.levels.keys()
        for k, (masks, counts) in fixed.levels.items():
            assert auto.levels[k][0].tobytes() == masks.tobytes()
            assert auto.levels[k][1].tobytes() == counts.tobytes()


def test_serving_auto_on_card_equals_every_family(cuda):
    from repro_torch.serving import RuleServeEngine, RuleStore
    tenants, baskets = _tenant_rules()
    queries = [(t, b) for pair in zip(*[[(t, b) for b in baskets[t]]
                                        for t in tenants]) for t, b in pair]
    batches = [queries[i:i + 8] for i in range(0, len(queries), 8)]
    out = {}
    for impl in ("auto", "jnp", "matmul"):
        eng = RuleServeEngine(RuleStore(tenants=tenants, device=cuda),
                              impl=impl, top_k=4, device=cuda)
        eng.warmup(128)
        if impl == "auto":
            plans = eng.store.state.plans
            assert sorted(plans) == [8, 16, 32, 64, 128]
            assert set(plans.values()) <= {"jnp", "matmul"}
            kernels.reset_launches()
        out[impl], _ = eng.serve(batches)
        if impl == "auto":        # the serving loop sweeps nothing
            assert sum(kernels.LAUNCHES.values()) == len(eng.records)
    assert out["auto"] == out["jnp"] == out["matmul"]


def test_stream_auto_on_card_equals_every_family(cuda):
    from repro_torch.stream import StreamMiner, levels_equal
    rng = np.random.default_rng(10)
    base = rng.random((3, 20)) < 0.5
    txns = []
    for _ in range(400):
        row = np.where(rng.random(20) < 0.85, base[rng.integers(3)],
                       rng.random(20) < 0.1)
        txns.append(np.nonzero(row)[0].tolist() or [0])
    miners = {impl: StreamMiner(20, 0.3, capacity=128, impl=impl,
                                staleness_factor=1e9, device=cuda)
              for impl in ("auto", "jnp", "matmul")}
    for lo in range(0, 400, 40):
        for m in miners.values():
            m.push(txns[lo:lo + 40])
        for impl in ("jnp", "matmul"):
            assert levels_equal(miners["auto"].levels, miners[impl].levels)
    fams = miners["auto"].delta_families
    assert sum(fams.values()) > 0 and set(fams) <= {"jnp", "matmul"}


# -- the (data, cand) mining mesh on the card -----------------------------------

MESH_SPLITS = [(4, 1), (2, 2), (1, 4), (1, 16)]


def _mesh_txns(seed=7, n=500, n_items=40):
    rng = np.random.default_rng(seed)
    return [sorted(set(rng.integers(0, n_items, rng.integers(2, 12))
                       .tolist())) for _ in range(n)]


@pytest.mark.parametrize("split", MESH_SPLITS)
@pytest.mark.parametrize("family", sorted(FAMILY_KERNEL))
def test_mesh_on_card_equals_one_cell(cuda, family, split):
    """Every cell of the mesh on cuda:0: levels byte-identical to one cell
    on the CPU, and the family's kernel launched once a cell a job."""
    from repro_torch.launch.mesh import make_mining_mesh
    txns = _mesh_txns()
    cells = split[0] * split[1]
    rt = MapReduceRuntime(
        mesh=make_mining_mesh(*split, cells_per_process=cells, device=cuda),
        impl=family, cand_axis="cand" if split[1] > 1 else None)
    kernels.reset_launches()
    on_card = mine(txns, n_items=40, min_sup=0.1, runtime=rt, elastic=False)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[FAMILY_KERNEL[family]] == \
        cells * on_card.dispatches > 0
    on_cpu = mine(txns, n_items=40, min_sup=0.1,
                  runtime=MapReduceRuntime(impl=family, device="cpu"))
    assert on_card.levels.keys() == on_cpu.levels.keys()
    for k, (masks, counts) in on_cpu.levels.items():
        assert on_card.levels[k][0].tobytes() == masks.tobytes()
        assert on_card.levels[k][1].tobytes() == counts.tobytes()
    assert on_card.itemsets() == sequential_apriori(txns, 0.1)


def _shard_case(C, T, n_items=192, seed=3):
    """Transactions of about 20 of 192 items and candidates of 1–3 items:
    most counts non-zero (c20d200k's shape at a mesh cell)."""
    rng = np.random.default_rng(seed)
    txns = np.packbits(rng.random((T, 192)) < 0.1, axis=1,
                       bitorder="little").view(np.uint32)
    idx = np.full((C, 3), n_items, np.int32)
    cands = np.zeros((C, 6), np.uint32)
    for i in range(C):
        items = rng.choice(n_items, rng.integers(1, 4), replace=False)
        idx[i, :items.size] = items
        for it in items:
            cands[i, it // 32] |= np.uint32(1 << (it % 32))
    return cands, np.ascontiguousarray(txns), idx


@pytest.mark.parametrize("C,T", [(2560, 200000), (40960, 50000)],
                         ids=["narrow_cand_shard", "data_shard"])
@pytest.mark.parametrize("name", sorted(FAMILY_KERNEL.values()))
def test_kernel_at_mesh_cell_shapes(cuda, name, C, T):
    """The counting kernels at the shapes a cell gets on c20d200k: 2,560
    candidate rows of a (1, 16) split, 50,000 transactions (Tw 1,563) of a
    (4, 1) split."""
    cands, txns, idx = _shard_case(C, T)
    if name.startswith("vertical"):
        args = (to_device_words(vertical_pack(txns, 192), cuda),
                torch.from_numpy(idx).to(cuda))
        assert args[0].shape[1] == -(-T // 32)
    else:
        args = (to_device_words(cands, cuda), to_device_words(txns, cuda))
    wrapper, plain = kernels.KERNELS[name]
    got = wrapper(*args)
    want = plain(*args)
    assert torch.equal(got, want)
    assert int((want != 0).sum()) > C // 2


MESH_WORKER = r'''
import sys
import numpy as np
from repro_torch.core import MapReduceRuntime, mine
from repro_torch.launch.mesh import (init_distributed, make_mining_mesh,
                                     shutdown_distributed)

store, rank, backend, device, inputs, out = sys.argv[1:7]
rank = int(rank)
init_distributed(store, 2, rank, backend=backend, device=device, timeout=120)
data = np.load(inputs)
arrays = {}
for impl in ["jnp", "vertical"]:
    for split in [(2, 2), (4, 1)]:
        rt = MapReduceRuntime(
            mesh=make_mining_mesh(*split, cells_per_process=2, device=device),
            impl=impl, cand_axis="cand" if split[1] > 1 else None)
        res = mine(db_masks=data["db"], n_items=40, min_sup=0.1, runtime=rt,
                   elastic=False)
        for k, (m, c) in res.levels.items():
            arrays[f"{impl}/{split}|{k}|m"] = m
            arrays[f"{impl}/{split}|{k}|c"] = c
shutdown_distributed()
np.savez(out, **arrays)
'''


@pytest.fixture
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (NCCL takes one rank a card)")


def _two_processes(tmp_path, backend, device):
    import os
    import subprocess
    import sys
    txns = _mesh_txns()
    db = pack_itemsets(txns, 40)
    np.savez(tmp_path / "db.npz", db=db)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    procs = [subprocess.Popen(
        [sys.executable, "-c", MESH_WORKER, f"file://{tmp_path / 'store'}",
         str(rank), backend, device, str(tmp_path / "db.npz"),
         str(tmp_path / f"out{rank}.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in (0, 1)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    one = mine(txns, n_items=40, min_sup=0.1,
               runtime=MapReduceRuntime(impl="jnp", device="cpu"))
    for rank in (0, 1):
        got = dict(np.load(tmp_path / f"out{rank}.npz"))
        for impl in ["jnp", "vertical"]:
            for split in [(2, 2), (4, 1)]:
                for k, (masks, counts) in one.levels.items():
                    tag = f"{impl}/{split}|{k}|"
                    assert got[tag + "m"].tobytes() == masks.tobytes()
                    assert got[tag + "c"].tobytes() == counts.tobytes()


def test_two_processes_on_one_card_through_gloo(cuda, tmp_path):
    """Both processes on the card (NCCL refuses two ranks on one GPU; gloo
    all-reduces card tensors), two cells each, whatever cards the host
    has."""
    _two_processes(tmp_path, "gloo", "cuda:0")


def test_two_processes_on_two_cards_through_nccl(two_cards, tmp_path):
    _two_processes(tmp_path, "nccl", "cuda")


# -- LM serving (repro_torch.models, repro_torch.serving.engine) -----------------

LM_BF16_TOL = 0.03      # tests/test_torch_models.py's bf16 tolerance


def _teacher_forced(model, toks, S):
    """prefill(toks[:, :S]) and one decode step a later token: logits."""
    dev = model.device
    toks = torch.as_tensor(toks, dtype=torch.long, device=dev)
    B, T = toks.shape
    logits, caches = model.prefill({"tokens": toks[:, :S]}, T)
    out = [logits]
    for t in range(S, T):
        logits, caches = model.decode_step(
            caches, toks[:, t:t + 1],
            torch.full((B,), t, dtype=torch.long, device=dev))
        out.append(logits)
    return torch.stack(out).float().cpu()


def _lm_serve(model, prompts, lens, algo, max_new=16, extra_batch=None,
              **kw):
    from repro_torch.costmodel import CostController, CostModel
    from repro_torch.serving import ServeEngine
    if algo == "measured":
        kw["controller"] = CostController(CostModel(persist=False),
                                          device=model.device)
    eng = ServeEngine(model, cache_len=prompts.shape[1] + max_new,
                      algorithm=algo, **kw)
    return eng.generate(prompts, prompt_lens=lens, max_new_tokens=max_new,
                        extra_batch=extra_batch)[0]


def _lm_prompts(vocab, B, S, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(max(S // 4, 1), S + 1, B).astype(np.int32)
    prompts = rng.integers(1, vocab, (B, S)).astype(np.int32)
    for i, n in enumerate(lens):
        prompts[i, n:] = 0
    return prompts, lens


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_smoke_on_the_card_matches_the_cpu(cuda, dtype, monkeypatch):
    """qwen3-14b's smoke config, GQA group padded 5 → 6: the same weights
    on the card and on the CPU.  float32 (TF32 off): logits within 1e-4
    and every algorithm's tokens equal; bf16: logits within the CPU tests'
    tolerance."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.policy import ALGORITHMS
    from repro_torch.models import build_model
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(get_config("qwen3-14b", smoke=True),
                              q_head_pad_group=6, dtype=dtype)
    cpu = build_model(cfg, device="cpu", seed=3)
    card = build_model(cfg, device=cuda, seed=None)
    card.load_state_dict(cpu.state_dict())
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 16))
    V = cfg.vocab_size                  # not the padded vocab's -1e30
    want = _teacher_forced(cpu, toks, 12)[..., :V]
    got = _teacher_forced(card, toks, 12)[..., :V]
    err = float((want - got).abs().max() / want.abs().max())
    assert err <= (1e-4 if dtype == "float32" else LM_BF16_TOL)
    if dtype == "float32":
        prompts, lens = _lm_prompts(cfg.vocab_size, 4, 8)
        base = _lm_serve(cpu, prompts, lens, "spc")
        for algo in sorted(ALGORITHMS):
            np.testing.assert_array_equal(
                _lm_serve(card, prompts, lens, algo), base)


def test_lm_full_smollm_engine_policies_agree(cuda):
    """smollm-135m at its full config on the card: every algorithm, and a
    pipelined engine, give spc's tokens for ragged prompts."""
    from repro_torch.core.policy import ALGORITHMS
    from repro_torch.models import build_model
    model = build_model("smollm-135m", device=cuda, seed=0)
    prompts, lens = _lm_prompts(model.cfg.vocab_size, 8, 64)
    base = _lm_serve(model, prompts, lens, "spc", 32)
    for algo in sorted(ALGORITHMS):
        np.testing.assert_array_equal(
            _lm_serve(model, prompts, lens, algo, 32), base)
    np.testing.assert_array_equal(
        _lm_serve(model, prompts, lens, "optimized_vfpc", 32,
                  pipeline_depth=2), base)


# -- the other families (models/{moe,ssm,encdec}.py) ---------------------------

FAMILY_ARCHS = ["granite-moe-3b-a800m", "qwen3-moe-30b-a3b", "mamba2-370m",
                "jamba-v0.1-52b", "whisper-small", "internvl2-76b"]


def _family_extra(cfg, B, device, dtype=torch.float32):
    """The frontend stubs' inputs from a seed, on ``device``."""
    gen = torch.Generator().manual_seed(5)
    n = {"vision_stub": cfg.n_frontend_tokens,
         "audio_stub": cfg.enc_seq}.get(cfg.frontend)
    if n is None:
        return {}
    key = "vision_embeds" if cfg.frontend == "vision_stub" else "frame_embeds"
    embeds = 0.5 * torch.randn((B, n, cfg.d_model), generator=gen)
    return {key: embeds.to(device=device, dtype=dtype)}


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_lm_family_smoke_on_the_card_matches_the_cpu(cuda, arch,
                                                     monkeypatch):
    """Each family's smoke config in float32 (TF32 off), the same weights
    on the card and the CPU: teacher-forced logits over prefill and 4
    decode steps within 1e-4, and every algorithm's tokens for ragged
    prompts (the frontend inputs through ``extra_batch``) equal to the
    CPU's spc."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.policy import ALGORITHMS
    from repro_torch.models import build_model
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    cpu = build_model(cfg, device="cpu", seed=3)
    card = build_model(cfg, device=cuda, seed=None)
    card.load_state_dict(cpu.state_dict())
    S = 12 + cfg.n_frontend_tokens
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, S + 4))
    V = cfg.vocab_size
    logits = []
    for model in (cpu, card):
        dev = model.device
        t = torch.as_tensor(toks, dtype=torch.long, device=dev)
        out, caches = model.prefill({"tokens": t[:, :S],
                                     **_family_extra(cfg, 4, dev)}, S + 4)
        steps = [out]
        for i in range(S, S + 4):
            out, caches = model.decode_step(
                caches, t[:, i:i + 1],
                torch.full((4,), i, dtype=torch.long, device=dev))
            steps.append(out)
        logits.append(torch.stack(steps).cpu()[..., :V])
    err = float((logits[0] - logits[1]).abs().max() / logits[0].abs().max())
    assert err <= 1e-4
    prompts, lens = _lm_prompts(cfg.vocab_size, 4, S)
    base = _lm_serve(cpu, prompts, lens, "spc",
                     extra_batch=_family_extra(cfg, 4, "cpu"))
    for algo in sorted(ALGORITHMS):
        np.testing.assert_array_equal(
            _lm_serve(card, prompts, lens, algo,
                      extra_batch=_family_extra(cfg, 4, cuda)), base)


def test_lm_full_mamba2_engine_policies_agree(cuda):
    """mamba2-370m at its full config on the card (48 SSD layers): every
    algorithm, and a pipelined engine, give spc's tokens for ragged
    prompts."""
    from repro_torch.core.policy import ALGORITHMS
    from repro_torch.models import build_model
    model = build_model("mamba2-370m", device=cuda, seed=0)
    prompts, lens = _lm_prompts(model.cfg.vocab_size, 8, 64)
    base = _lm_serve(model, prompts, lens, "spc", 32)
    for algo in sorted(ALGORITHMS):
        np.testing.assert_array_equal(
            _lm_serve(model, prompts, lens, algo, 32), base)
    np.testing.assert_array_equal(
        _lm_serve(model, prompts, lens, "optimized_vfpc", 32,
                  pipeline_depth=2), base)
