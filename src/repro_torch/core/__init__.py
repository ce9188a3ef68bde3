"""Core: MapReduce-based Apriori with combined-pass phases, on one torch
device (the port of the JAX package's ``repro.core``)."""

from .bitset import pack_itemsets, unpack_itemsets, n_words, singleton_masks
from .drivers import mine, MiningResult
from .mapreduce import IMPLS, MapReduceRuntime
from .policy import ALGORITHMS
from .sequential import sequential_apriori

__all__ = [
    "pack_itemsets", "unpack_itemsets", "n_words", "singleton_masks",
    "mine", "MiningResult", "MapReduceRuntime", "IMPLS", "ALGORITHMS",
    "sequential_apriori",
]
