"""The roofline yardstick: the least time the card needs for the work a task
needs, whatever implements it.

Each input byte is read once and each output byte written once; the
operations are the bit tests the answer needs, at the card's fastest rate for
them (``peaks.json`` says which rate and where it comes from).  A kernel's
share is this least time over its device time from the trace.
"""

from __future__ import annotations

import json
import os

_PEAKS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "peaks.json")


def peaks() -> dict:
    with open(_PEAKS) as f:
        return json.load(f)


def least_seconds(ops: float, nbytes: float, pk: dict) -> float:
    return max(ops / pk["b1_ops_per_s"], nbytes / pk["hbm_bytes_per_s"])


def count_work(n_candidates: int, n_txns: int, n_items: int) -> tuple:
    """One counting job: every candidate's support over every transaction.
    Reads the transactions and the candidates as packed words, writes one
    int32 count a candidate; tests ``n_items`` bits a pair."""
    words = -(-n_items // 32)
    ops = 2.0 * n_candidates * n_txns * n_items
    nbytes = 4.0 * words * (n_txns + n_candidates) + 4.0 * n_candidates
    return ops, nbytes


def rule_work(n_queries: int, n_rules: int, n_items: int, fetch: int) -> tuple:
    """One scoring dispatch: every rule's antecedent and consequent against
    every basket.  Reads both rule masks, the rule scores and the baskets,
    writes each basket's ``fetch`` best (float32 score, int32 rule)."""
    words = -(-n_items // 32)
    ops = 2.0 * 2.0 * n_queries * n_rules * n_items
    nbytes = (4.0 * words * (2 * n_rules + n_queries) + 4.0 * n_rules
              + 8.0 * n_queries * fetch)
    return ops, nbytes
