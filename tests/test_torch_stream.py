"""The port's streaming path against the JAX package's: the window ring,
signed delta counting, and incremental mining that equals a from-scratch
mine at every step and the reference ``StreamMiner``'s levels.

The port runs on the CPU through its kernels' plain versions; the CUDA
kernels run only on a card (``test_torch_gpu.py``).
"""

import numpy as np
import pytest
import torch

from repro.kernels.delta_count import build_slab as ref_build_slab
from repro.kernels.delta_count import delta_count as ref_delta_count
from repro.kernels.delta_count import (delta_count_matmul_pallas,
                                       delta_count_pallas)
from repro.stream import StreamMiner as RefStreamMiner
from repro_torch.core import MapReduceRuntime, mine
from repro_torch.core.bitset import pack_itemsets, to_device_words
from repro_torch.kernels.delta_count import (DELTA_IMPLS, build_slab,
                                             delta_count,
                                             delta_count_matmul_plain,
                                             delta_count_popcount_plain)
from repro_torch.stream import StreamMiner, TransactionWindow, levels_equal

N_ITEMS, MIN_SUP = 12, 0.3
NEVER_STALE = 1e9     # staleness factor that never fires: paths stay exact


def toy_txns(n, seed=0, n_items=N_ITEMS, drop=None):
    """The ``test_stream.py`` generator: patterned random baskets."""
    rng = np.random.default_rng(seed)
    base = rng.random((3, n_items)) < 0.5
    out = []
    for _ in range(n):
        pat = base[rng.integers(3)]
        row = np.where(rng.random(n_items) < 0.85, pat,
                       rng.random(n_items) < 0.1)
        t = np.nonzero(row)[0].tolist() or [0]
        if drop is not None:
            t = [i for i in t if i not in drop] or [0]
        out.append(t)
    return out


# -- delta counting --------------------------------------------------------------

def _delta_case(C, A, E, W, seed):
    rng = np.random.default_rng(seed)
    cands = (rng.integers(0, 2**32, (C, W), dtype=np.uint32)
             & rng.integers(0, 2**32, (C, W), dtype=np.uint32)
             & rng.integers(0, 2**32, (C, W), dtype=np.uint32))
    cands[C // 2] = 0                           # an empty candidate row
    added = ~(rng.integers(0, 2**32, (A, W), dtype=np.uint32)
              & rng.integers(0, 2**32, (A, W), dtype=np.uint32))
    evicted = ~(rng.integers(0, 2**32, (E, W), dtype=np.uint32)
                & rng.integers(0, 2**32, (E, W), dtype=np.uint32))
    return cands, added, evicted


DELTA_SHAPES = [(1, 1, 0, 1), (37, 23, 11, 2), (300, 70, 90, 3),
                (129, 0, 40, 4), (64, 33, 33, 8), (40, 17, 19, 9)]


@pytest.mark.parametrize("C,A,E,W", DELTA_SHAPES)
@pytest.mark.parametrize("impl", ["jnp", "matmul"])
def test_delta_count_equals_reference(C, A, E, W, impl):
    cands, added, evicted = _delta_case(C, A, E, W, seed=C + A + E + W)
    want = ref_delta_count(cands, added, evicted, impl="jnp", autotune=False)
    np.testing.assert_array_equal(
        ref_delta_count(cands, added, evicted, impl=impl, autotune=False),
        want)
    got = delta_count(cands, added, evicted, impl=impl, device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("C,A,E,W", DELTA_SHAPES)
def test_plain_versions_equal_the_pallas_kernels(C, A, E, W):
    """On the slab the host wrapper builds: the reference's two Pallas
    kernels in interpret mode against both plain versions."""
    cands, added, evicted = _delta_case(C, A, E, W, seed=C * 7 + W)
    slab, signs = build_slab(added, evicted)
    ref_slab, ref_signs = ref_build_slab(added, evicted)
    np.testing.assert_array_equal(slab, ref_slab)
    np.testing.assert_array_equal(signs, ref_signs)
    bc = 8
    padded = np.concatenate([cands, np.zeros(((-C) % bc, W), np.uint32)])
    want = np.asarray(delta_count_pallas(padded, slab, signs, bc=bc, bt=32,
                                         interpret=True))[:C]
    np.testing.assert_array_equal(
        np.asarray(delta_count_matmul_pallas(padded, slab, signs, bc=bc,
                                             bt=32, interpret=True))[:C],
        want)
    c, t = to_device_words(cands, "cpu"), to_device_words(slab, "cpu")
    s = torch.from_numpy(signs)
    for fn in (delta_count_popcount_plain, delta_count_matmul_plain):
        for block in (None, 1, 7):
            np.testing.assert_array_equal(fn(c, t, s, block).numpy(), want)


def test_delta_count_edges_and_impl_names():
    cands, added, evicted = _delta_case(9, 5, 3, 2, seed=1)
    zero = np.zeros((0, 2), np.uint32)
    assert not delta_count(cands, zero, zero, device="cpu").any()
    assert delta_count(cands[:0], added, evicted, device="cpu").shape == (0,)
    np.testing.assert_array_equal(
        delta_count(cands, added, evicted, impl="auto", device="cpu"),
        delta_count(cands, added, evicted, impl="jnp", device="cpu"))
    assert DELTA_IMPLS == ("auto", "jnp", "matmul")
    for bad in ("pallas", "pallas_interpret", "matmul_pallas"):
        with pytest.raises(ValueError, match="'jnp' .popcount kernel. and "
                                             "'matmul'"):
            delta_count(cands, added, evicted, impl=bad, device="cpu")


# -- the window --------------------------------------------------------------------

def _device_ring(w: TransactionWindow) -> np.ndarray:
    return w.device_masks().numpy().view(np.uint32)


def _host_ring(w: TransactionWindow) -> np.ndarray:
    host = np.zeros((w.capacity, w.W), np.uint32)
    host[(w._start + np.arange(w.size)) % w.capacity] = w.contents()
    return host


def test_window_ring_semantics_and_device_mirror():
    w = TransactionWindow(N_ITEMS, capacity=100, device="cpu")
    assert w.capacity == 128
    txns = toy_txns(300, seed=1)
    d1 = w.append(txns[:100])
    assert (d1.n_added, d1.n_evicted, w.size) == (100, 0, 100)
    d2 = w.append(txns[100:140])                     # overflows by 12
    assert (d2.n_added, d2.n_evicted, w.size) == (40, 12, 128)
    np.testing.assert_array_equal(d2.evicted,
                                  pack_itemsets(txns[:12], N_ITEMS))
    np.testing.assert_array_equal(_device_ring(w), _host_ring(w))
    d3 = w.evict(20)
    np.testing.assert_array_equal(d3.evicted,
                                  pack_itemsets(txns[12:32], N_ITEMS))
    w.append(txns[140:170])                          # wraps the ring
    np.testing.assert_array_equal(_device_ring(w), _host_ring(w))
    big = txns[170:300]                              # more than the capacity
    d4 = w.append(big)
    assert w.size == 128 and d4.n_added == 128
    np.testing.assert_array_equal(w.contents(),
                                  pack_itemsets(big[-128:], N_ITEMS))
    np.testing.assert_array_equal(_device_ring(w), _host_ring(w))
    w.evict(w.size)
    assert w.size == 0 and not _device_ring(w).any()


def test_window_landmark_grows():
    w = TransactionWindow(N_ITEMS, capacity=64, mode="landmark",
                          device="cpu")
    txns = toy_txns(200, seed=4)
    for i in range(0, 200, 50):
        assert w.append(txns[i:i + 50]).n_evicted == 0
    assert w.size == 200 and w.capacity == 256
    np.testing.assert_array_equal(w.contents(), pack_itemsets(txns, N_ITEMS))
    np.testing.assert_array_equal(_device_ring(w), _host_ring(w))
    assert w.device_masks().dtype == torch.int32


# -- incremental mining ------------------------------------------------------------

def _scratch(miner):
    return mine(db_masks=miner.window.contents(), n_items=miner.n_items,
                min_sup=miner.min_sup, algorithm=miner.algorithm,
                device="cpu").levels


def _ops(seed):
    """A seeded mix of appends, bursts of drifted baskets and evictions."""
    rng = np.random.default_rng(seed)
    ops, drift = [], toy_txns(400, seed=seed + 100, drop={0, 1, 2})
    for i in range(8):
        kind = rng.integers(3)
        if kind == 0:
            ops.append(("push", toy_txns(int(rng.integers(8, 40)),
                                         seed=seed * 10 + i)))
        elif kind == 1:
            ops.append(("push", drift[i * 40:i * 40 + int(rng.integers(8, 40))]))
        else:
            ops.append(("evict", int(rng.integers(1, 30))))
    return [("push", toy_txns(120, seed=seed))] + ops


@pytest.mark.parametrize("seed,mode,impl", [(0, "sliding", "jnp"),
                                            (1, "sliding", "matmul"),
                                            (2, "landmark", "jnp"),
                                            (3, "sliding", "auto")])
def test_incremental_equals_scratch_and_reference(seed, mode, impl):
    kw = dict(capacity=128, mode=mode, staleness_factor=NEVER_STALE,
              min_confidence=0.6)
    port = StreamMiner(N_ITEMS, MIN_SUP, impl=impl, device="cpu", **kw)
    ref = RefStreamMiner(N_ITEMS, MIN_SUP, impl="jnp", autotune=False, **kw)
    for op, arg in _ops(seed):
        if op == "push":
            got, want = port.push(arg), ref.push(arg)
        else:
            got, want = port.evict(arg), ref.evict(arg)
        assert got.path == want.path
        assert (got.n_frequent, got.n_rules, got.window_size) == \
            (want.n_frequent, want.n_rules, want.window_size)
        assert levels_equal(port.levels, ref.levels)
        if port.window.size:
            assert levels_equal(port.levels, _scratch(port))
    assert port.n_tracked == ref.n_tracked
    paths = {u.path for u in port.updates}
    assert "delta" in paths


def wide_txns(n, seed, n_items=300):
    """Sparse baskets over a catalog wider than 256 items (W = 10 words):
    two patterns that reach items past 256, plus a little noise."""
    rng = np.random.default_rng(seed)
    base = [[3, 70, 255, 256, 280, n_items - 1], [5, 129, 257, 290, 291]]
    out = []
    for _ in range(n):
        pat = base[rng.integers(2)]
        keep = [i for i in pat if rng.random() < 0.85]
        noise = rng.integers(0, n_items, 2).tolist()
        out.append(sorted(set(keep + noise)))
    return out


@pytest.mark.parametrize("impl", ["jnp", "matmul"])
def test_wide_catalog_streams_past_256_items(impl):
    """Streaming over more than 256 items takes the delta path, equal to
    scratch and to the reference at every update."""
    kw = dict(capacity=128, staleness_factor=NEVER_STALE)
    port = StreamMiner(300, MIN_SUP, impl=impl, device="cpu", **kw)
    ref = RefStreamMiner(300, MIN_SUP, impl="jnp", autotune=False, **kw)
    assert port.window.W == 10
    for lo in range(0, 320, 40):
        batch = wide_txns(40 if lo else 128, seed=lo)
        got, want = port.push(batch), ref.push(batch)
        assert got.path == want.path
        assert levels_equal(port.levels, ref.levels)
        assert levels_equal(port.levels, _scratch(port))
    assert any(k >= 2 and (m[:, 8:] != 0).any()
               for k, (m, _) in port.levels.items())
    assert "delta" in {u.path for u in port.updates}


def test_rule_refresh_serves_the_reference_rules():
    kw = dict(capacity=128, staleness_factor=NEVER_STALE, min_confidence=0.6)
    port = StreamMiner(N_ITEMS, MIN_SUP, device="cpu",
                       serve_kwargs={"top_k": 3}, **kw)
    ref = RefStreamMiner(N_ITEMS, MIN_SUP, autotune=False,
                         serve_kwargs={"top_k": 3, "impl": "jnp",
                                       "autotune": False}, **kw)
    baskets = [t[:-1] for t in toy_txns(20, seed=9)]
    for batch in (toy_txns(128, seed=3), toy_txns(30, seed=4),
                  toy_txns(40, seed=5, drop={3})):
        port.push(batch)
        ref.push(batch)
        got = [[(r.consequent, r.confidence, r.lift, r.score) for r in recs]
               for recs in port.query(baskets)]
        want = [[(r.consequent, r.confidence, r.lift, r.score) for r in recs]
                for recs in ref.query(baskets)]
        assert got == want
    assert port.engine.store.version("default") == \
        ref.engine.store.version("default") > 0


def test_oracle_check_and_empty_window_round_trip():
    miner = StreamMiner(N_ITEMS, MIN_SUP, capacity=64, oracle_check=True,
                        device="cpu")
    assert miner.push(toy_txns(50, seed=6)).path == "remine"
    assert miner.evict(50).path == "empty" and miner.levels == {}
    assert miner.push(toy_txns(20, seed=7)).path == "remine"
    assert levels_equal(miner.levels, _scratch(miner))


def test_devices_are_checked(monkeypatch):
    with pytest.raises(ValueError, match="counts on cpu"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        StreamMiner(N_ITEMS, MIN_SUP, runtime=MapReduceRuntime(device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamMiner(N_ITEMS, MIN_SUP)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransactionWindow(N_ITEMS)
    with pytest.raises(ValueError, match="'jnp' .popcount kernel. and "
                                         "'matmul'"):
        StreamMiner(N_ITEMS, MIN_SUP, impl="pallas", device="cpu")
