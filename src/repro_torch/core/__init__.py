"""Core: MapReduce-based Apriori with combined-pass phases, on a
``(data, cand)`` mesh of cells over torch devices (the port of the JAX
package's ``repro.core``)."""

from .bitset import pack_itemsets, unpack_itemsets, n_words, singleton_masks
from .drivers import mine, MiningResult
from .mapreduce import IMPLS, MapReduceRuntime, RuntimeStats, ShardedDB
from .policy import ALGORITHMS
from .rules import Rule, RuleSet, generate_rules, generate_ruleset
from .sequential import sequential_apriori

__all__ = [
    "pack_itemsets", "unpack_itemsets", "n_words", "singleton_masks",
    "mine", "MiningResult", "MapReduceRuntime", "RuntimeStats", "ShardedDB",
    "IMPLS", "ALGORITHMS",
    "sequential_apriori", "Rule", "RuleSet", "generate_rules",
    "generate_ruleset",
]
