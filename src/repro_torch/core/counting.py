"""Device-side support counting used inside the MapReduce runtime.

The Mapper + Combiner of one split: count every candidate against the
device's transactions.  Each family reaches one hand-written CUDA kernel on
a card and that kernel's plain PyTorch version on the CPU
(:mod:`repro_torch.kernels`).  The kernels choose their own tiles from the
shape; which family counts is the runtime's choice, the autotuner's
cross-family plan under ``impl="auto"`` (``kernels/autotune.py``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.support_count import (support_count,
                                               support_count_matmul)
from repro_torch.kernels.vertical_count import (vertical_count,
                                                vertical_count_matmul)

_HORIZONTAL = {"jnp": support_count, "matmul": support_count_matmul}
_VERTICAL = {"jnp": vertical_count, "matmul": vertical_count_matmul}


def local_counts(db_local: torch.Tensor, cands: torch.Tensor,
                 impl: str) -> torch.Tensor:
    """Per-device support counts, horizontal layout.

    Args:
      db_local: (N, W) int32 words — the device's transactions.
      cands:    (C, W) int32 words — candidate bitmasks.
      impl:     "jnp" (popcount-AND) | "matmul" (bit-plane matmul).

    Returns: (C,) int32 counts.
    """
    if impl not in _HORIZONTAL:
        raise ValueError(f"unknown impl {impl!r}")
    return _HORIZONTAL[impl](cands, db_local)


def local_counts_vertical(vdb_local: torch.Tensor, cand_idx: torch.Tensor,
                          impl: str = "jnp") -> torch.Tensor:
    """Vertical-layout support counting (DESIGN.md §3).

    vdb_local: (I+1, Tw) int32 — item-major transaction bitmaps; row I is
      the valid-transaction mask (AND identity for padding).
    cand_idx: (C, kmax) int32 — item ids per candidate, padded with I.
    impl: "jnp" (popcount-AND) | "matmul" (membership matmul).
    """
    if impl not in _VERTICAL:
        raise ValueError(f"unknown vertical impl {impl!r}")
    return _VERTICAL[impl](vdb_local, cand_idx)
