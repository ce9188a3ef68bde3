"""Serving on the port: the LM ``ServeEngine`` (policy-fused greedy
decode, ``engine.py``) and rule serving (DESIGN.md §7/§12): the tenant
arena, the serving engine over the rule-scoring kernels, and open-loop
admission.
"""

from .admission import (OpenLoopServer, QueryOutcome, ResultCache,
                        basket_key)
from .common import outcome_summary
from .engine import ServeEngine, ServePhaseRecord
from .rule_store import DEFAULT_TENANT, ArenaState, RuleStore
from .rules_engine import (Recommendation, RuleServeEngine, RuleServeRecord,
                           RULE_IMPLS, stable_top_k)

__all__ = ["ServeEngine", "ServePhaseRecord",
           "Recommendation", "RuleServeEngine", "RuleServeRecord",
           "RULE_IMPLS", "stable_top_k",
           "RuleStore", "ArenaState", "DEFAULT_TENANT",
           "OpenLoopServer", "QueryOutcome", "ResultCache", "basket_key",
           "outcome_summary"]
