"""Shape bucketing shared by the kernels' callers (the port's copy of
``_bucket`` from the JAX package's ``kernels/autotune.py``).

The block-size autotuner and the cross-family plan of that module are not
ported yet: until they are, ``impl="auto"`` in the rule-serving and
streaming paths resolves statically (ROADMAP Queue 1 item 1).
"""

from __future__ import annotations


def _bucket(n: int) -> int:
    """Next power of two ≥ n (≥ 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()
