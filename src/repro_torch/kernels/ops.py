"""Public counting entry point over host bitmasks (the reference's
``kernels/ops.support_count``).

``support_count(cands, txns, impl, device)`` takes ``(C, W)`` / ``(T, W)``
uint32 numpy masks, moves them to ``device`` as int32 words and returns host
int32 counts.  ``impl="auto"`` picks the matmul form on a card (the
reference's GPU default, ``ops.py:90``) and the popcount form on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bitset import to_device_words

from .support_count import support_count as _support_count_popcount
from .support_count import support_count_matmul


def support_count(cands, txns, impl: str = "auto",
                  device="cuda") -> np.ndarray:
    """Count, for each bitmask candidate, the transactions that contain it.

    Returns (C,) int32.  An empty candidate counts every transaction.
    """
    device = torch.device(device)
    if impl == "auto":
        impl = "matmul" if device.type == "cuda" else "jnp"
    fns = {"jnp": _support_count_popcount, "matmul": support_count_matmul}
    if impl not in fns:
        raise ValueError(f"unknown impl {impl!r}; options: {sorted(fns)}")
    c = to_device_words(np.asarray(cands), device)
    t = to_device_words(np.asarray(txns), device)
    return fns[impl](c, t).cpu().numpy()
