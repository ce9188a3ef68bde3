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
                                   (1000, 4099, 6), (33, 257, 3)])
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
    with pytest.raises(ValueError, match="1..8 words"):
        kernels.support_count(wide, wide)
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
