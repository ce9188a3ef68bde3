"""Rule serving on the port (DESIGN.md §7/§12): the tenant arena, the
serving engine over the rule-scoring kernels, and open-loop admission.

The JAX package's LM ``ServeEngine`` belongs to the LM stack and is not
ported yet.
"""

from .admission import (OpenLoopServer, QueryOutcome, ResultCache,
                        basket_key)
from .common import outcome_summary
from .rule_store import DEFAULT_TENANT, ArenaState, RuleStore
from .rules_engine import (Recommendation, RuleServeEngine, RuleServeRecord,
                           RULE_IMPLS, stable_top_k)

__all__ = ["Recommendation", "RuleServeEngine", "RuleServeRecord",
           "RULE_IMPLS", "stable_top_k",
           "RuleStore", "ArenaState", "DEFAULT_TENANT",
           "OpenLoopServer", "QueryOutcome", "ResultCache", "basket_key",
           "outcome_summary"]
