"""Signed delta counting for streaming windows: CUDA kernels, their plain
PyTorch versions and the host entry point (DESIGN.md §8).

A window update adds and evicts transactions.  Support counts are sums over
transactions, so the new count of every tracked candidate is

    count'[i] = count[i] + |{t ∈ added : c_i ⊆ t}| − |{t ∈ evicted : c_i ⊆ t}|

and an update only scans the O(delta) slab.  :func:`build_slab` stacks both
sides into one ``(T, W)`` slab with a per-row sign (+1 added, −1 evicted,
0 padding), and the kernels compute ``delta[i] = Σ_j sign[j]·[c_i ⊆ t_j]``:

* :func:`delta_count_popcount` — the popcount-AND subset test; kernel
  ``delta_count`` in ``csrc/delta_count.cu`` (replaces
  ``delta_count.py:_delta_count_kernel``), runtime family ``jnp``;
* :func:`delta_count_matmul` — the overlap form, ``overlap == width``
  weighted by the sign; kernel ``delta_count_matmul`` (replaces
  ``delta_count.py:_delta_count_matmul_kernel``), runtime family
  ``matmul``, which takes the overlaps from the single-bit tensor cores
  straight from the packed words (``csrc/overlap_mma.cuh``'s weighted bits
  mode) and counts the widths itself: its wrapper only checks and
  launches.  Its plain version unpacks bit planes and multiplies them, as
  the reference does.

Sign-0 padding contributes nothing, so unlike ``support_count`` no
empty-candidate correction is needed.  Each wrapper runs its plain version
for CPU tensors and launches its kernel for CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bitset import (to_device_words, tpopcount_rows,
                                     tunpack_bits)

from . import _build
from .autotune import _bucket, tuned_plan
from .support_count import (_check_pair, _on_cpu, full_float32,
                            rows_per_chunk)

DELTA_IMPLS = ("auto", "jnp", "matmul")
MIN_SLAB_BUCKET = 32        # pow2 slab padding floor — few slab shapes


def _check_signs(signs: torch.Tensor, txns: torch.Tensor) -> None:
    if (signs.dtype != torch.int32 or signs.shape != (txns.shape[0],)
            or not signs.is_contiguous() or signs.device != txns.device):
        raise ValueError(f"signs must be a contiguous ({txns.shape[0]},) "
                         f"int32 tensor on {txns.device}")


# -- popcount-AND form ---------------------------------------------------------

def delta_count_popcount_plain(cands: torch.Tensor, txns: torch.Tensor,
                               signs: torch.Tensor,
                               block: int | None = None) -> torch.Tensor:
    """Plain version of :func:`delta_count_popcount`: chunks of ``block``
    slab rows (default: about 2²⁴ tested words a chunk)."""
    C, W = cands.shape
    block = block or rows_per_chunk(C, W)
    out = torch.zeros(C, dtype=torch.int32, device=cands.device)
    c = cands[:, None, :]
    for s in range(0, txns.shape[0], block):
        match = ((c & txns[None, s:s + block]) == c).all(dim=-1)
        out += torch.where(match, signs[None, s:s + block],
                           0).sum(dim=1, dtype=torch.int32)
    return out


def delta_count_popcount(cands: torch.Tensor, txns: torch.Tensor,
                         signs: torch.Tensor) -> torch.Tensor:
    """(C,) int32 signed count deltas, popcount-AND form."""
    if _on_cpu(cands, txns, signs):
        return delta_count_popcount_plain(cands, txns, signs)
    W = _check_pair(cands, txns)
    _check_signs(signs, txns)
    C, T = cands.shape[0], txns.shape[0]
    out = torch.empty(C, dtype=torch.int32, device=cands.device)
    if C:
        _build.launch("delta_count", cands.data_ptr(), txns.data_ptr(),
                      signs.data_ptr(), C, T, W, out.data_ptr())
    return out


# -- bit-plane matmul form -----------------------------------------------------

@full_float32
def delta_count_matmul_plain(cands: torch.Tensor, txns: torch.Tensor,
                             signs: torch.Tensor,
                             block: int | None = None) -> torch.Tensor:
    """Plain version of :func:`delta_count_matmul`.

    The overlap is a float32 product: exact, because the operands are 0/1
    and every sum is at most 32·W ≤ 2²⁴ (torch's int8 matmul would wrap).
    """
    C = cands.shape[0]
    block = block or rows_per_chunk(C, 1)
    cb = tunpack_bits(cands).to(torch.float32)            # (C, 32W)
    widths = tpopcount_rows(cands).to(torch.float32)      # (C,)
    out = torch.zeros(C, dtype=torch.int32, device=cands.device)
    for s in range(0, txns.shape[0], block):
        tb = tunpack_bits(txns[s:s + block]).to(torch.float32)
        match = (cb @ tb.T) == widths[:, None]            # (C, block)
        out += torch.where(match, signs[None, s:s + block],
                           0).sum(dim=1, dtype=torch.int32)
    return out


def delta_count_matmul(cands: torch.Tensor, txns: torch.Tensor,
                       signs: torch.Tensor) -> torch.Tensor:
    """(C,) int32 signed count deltas, bit-plane matmul form."""
    if _on_cpu(cands, txns, signs):
        return delta_count_matmul_plain(cands, txns, signs)
    W = _check_pair(cands, txns)
    _check_signs(signs, txns)
    C, T = cands.shape[0], txns.shape[0]
    out = torch.empty(C, dtype=torch.int32, device=cands.device)
    if C:
        _build.launch("delta_count_matmul", cands.data_ptr(), txns.data_ptr(),
                      signs.data_ptr(), C, T, W, out.data_ptr())
    return out


# -- host entry point ----------------------------------------------------------

def slab_rows(n_rows: int, min_bucket: int = MIN_SLAB_BUCKET) -> int:
    """Rows of the padded slab that :func:`build_slab` makes of ``n_rows``
    added and evicted transactions."""
    return max(min_bucket, _bucket(max(n_rows, 1)))


def build_slab(added: np.ndarray, evicted: np.ndarray,
               min_bucket: int = MIN_SLAB_BUCKET):
    """Concatenate add/evict slabs, pad rows to a pow2 bucket with sign 0.

    Returns ``(slab (Tp, W) uint32, signs (Tp,) int32)`` — pow2-bucketed so
    a stream touches a handful of slab shapes.
    """
    added = np.asarray(added, np.uint32)
    evicted = np.asarray(evicted, np.uint32)
    W = added.shape[1] if added.ndim == 2 else evicted.shape[1]
    slab = np.concatenate([added, evicted], axis=0)
    signs = np.concatenate([np.ones(added.shape[0], np.int32),
                            -np.ones(evicted.shape[0], np.int32)])
    tp = slab_rows(slab.shape[0], min_bucket)
    if tp != slab.shape[0]:
        slab = np.concatenate(
            [slab, np.zeros((tp - slab.shape[0], W), np.uint32)], axis=0)
        signs = np.concatenate(
            [signs, np.zeros(tp - signs.shape[0], np.int32)])
    return slab, signs


_FAMILIES = {"jnp": delta_count_popcount, "matmul": delta_count_matmul}


def resolve_delta_impl(impl: str, *, C: int, T: int, W: int,
                       autotune: bool = True, device="cuda") -> str:
    """The family that ``impl`` names for a ``(C, T, W)`` update: itself, or
    for "auto" the ``delta`` plan winner (``kernels/autotune.py``), with
    "jnp", the reference's static choice off the TPU, as the fallback on
    the CPU and with autotune off."""
    if impl != "auto":
        return impl
    plan = (tuned_plan("delta", C=C, T=T, W=W, device=device)
            if autotune else None)
    return plan["impl"] if plan is not None else "jnp"


def delta_count(cands, added, evicted, impl: str = "auto",
                autotune: bool = True, device="cuda") -> np.ndarray:
    """Host wrapper: signed count delta per candidate for one window update.

    Args:
      cands:   (C, W) uint32 tracked candidate bitmasks (pre-bucket-padding
               them via ``phases.bucket_pad`` keeps the shape set small).
      added:   (A, W) uint32 transactions entering the window.
      evicted: (E, W) uint32 transactions leaving the window.
      impl:    "jnp" (the popcount kernel), "matmul" (the bit-plane kernel)
               or "auto" — the autotuned cross-family plan winner when
               autotune is on, else "jnp" (:func:`resolve_delta_impl`).
      autotune: consult the plan for "auto".
      device:  "cuda" (default; raises without a card) or "cpu" (the plain
               versions).

    Returns: (C,) int32 on the host — add to the tracked int64 counts.
    """
    if impl not in DELTA_IMPLS:
        raise ValueError(
            f"unknown impl {impl!r}; options: {DELTA_IMPLS} — the port has "
            f"two delta-counting families, 'jnp' (popcount kernel) and "
            f"'matmul' (bit-plane kernel)")
    # imported here: core.mapreduce imports this package through counting
    from repro_torch.core.mapreduce import resolve_device
    device = resolve_device(device)
    cands = np.asarray(cands, np.uint32)
    C = cands.shape[0]
    if C == 0:
        return np.zeros((0,), np.int32)
    slab, signs = build_slab(added, evicted)
    if not signs.any():
        return np.zeros((C,), np.int32)
    family = resolve_delta_impl(impl, C=C, T=slab.shape[0], W=cands.shape[1],
                                autotune=autotune, device=device)
    out = _FAMILIES[family](to_device_words(cands, device),
                            to_device_words(slab, device),
                            torch.from_numpy(signs).to(device))
    return out.cpu().numpy()
