"""PyTorch/CUDA port of the MapReduce Apriori miner.

A second package beside the JAX reference ``repro``: the same module layout
(``repro_torch/core/drivers.py`` ↔ ``repro/core/drivers.py``), torch tensors
on one device, and hand-written CUDA kernels for Hopper (``csrc/``) in place
of the reference's Pallas kernels.  It imports neither JAX nor ``repro``.

    from repro_torch import mine
    res = mine(txns, n_items=192, min_sup=0.125)            # on the card
    res = mine(txns, n_items=192, min_sup=0.125, device="cpu")
"""

from repro_torch.core import ALGORITHMS, MapReduceRuntime, MiningResult, mine

__all__ = ["ALGORITHMS", "MapReduceRuntime", "MiningResult", "mine"]
