"""Vertical (item-major) support counting: CUDA kernels and plain versions.

The vertical DB ``vdb`` is ``(I+1, Tw)`` int32 words: row ``i`` is the bitmap
of the transactions that contain item ``i``, row ``I`` the valid-transaction
mask, which doubles as the AND identity that pads short candidates
(DESIGN.md §3).  ``cand_idx`` is ``(C, kmax)`` int32 item ids padded with
``I``.  ``support(c) = popcount(AND_j vdb[idx[c, j]])``.

* :func:`vertical_count` — popcount-AND over gathered rows; kernel
  ``vertical_count`` in ``csrc/counting.cu`` (replaces
  ``vertical_count.py:_vertical_count_kernel``);
* :func:`vertical_count_matmul` — a 0/1 membership matrix ``A (C, I)``
  times the item bit planes: a candidate matches a transaction where
  ``Σ_i A[c, i]·V[i, t] == nreal[c]`` and the transaction is valid; kernel
  ``vertical_count_matmul`` (replaces
  ``vertical_count.py:_vertical_matmul_kernel``), which reads ``vdb`` and
  ``cand_idx`` as they are and builds ``A`` and the transposed planes in
  shared memory for the int8 tensor cores (``csrc/overlap_mma.cuh``).
  Duplicate slots collapse in ``A``, matching the AND's idempotence.

Each wrapper runs its plain version when its tensors lie on the CPU and
launches its kernel when they lie on a card, with no fallback between them.
"""

from __future__ import annotations

import torch

from repro_torch.core.bitset import tpopcount, tunpack_bits

from . import _build
from .support_count import _on_cpu, check_words, full_float32

DEFAULT_BLOCK = 2048          # plain popcount form: candidates a chunk
DEFAULT_MATMUL_BLOCK = 512    # plain matmul form: candidates a chunk


def _check_vertical(vdb: torch.Tensor, cand_idx: torch.Tensor) -> None:
    """Device/dtype/shape checks, plus the index range: an id outside
    ``[0, I]`` would make the kernel read outside ``vdb``.  Reading the range
    waits for the index upload, not for earlier kernels."""
    check_words("vdb", vdb, vdb.device)
    check_words("cand_idx", cand_idx, vdb.device)
    if cand_idx.shape[1] < 1:
        raise ValueError("cand_idx needs at least one slot (kmax >= 1)")
    if cand_idx.numel():
        lo, hi = torch.aminmax(cand_idx)
        if int(lo) < 0 or int(hi) >= vdb.shape[0]:
            raise ValueError(f"cand_idx holds ids in [{int(lo)}, {int(hi)}], "
                             f"outside the {vdb.shape[0]} rows of vdb")


# -- popcount-AND form ---------------------------------------------------------

def vertical_count_plain(vdb: torch.Tensor, cand_idx: torch.Tensor,
                         block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Plain version of :func:`vertical_count`: chunks of ``block``
    candidates, rows gathered and ANDed one slot at a time."""
    idx = cand_idx.to(torch.int64)
    out = []
    for s in range(0, idx.shape[0], block):
        blk = idx[s:s + block]
        acc = vdb[blk[:, 0]]
        for j in range(1, blk.shape[1]):
            acc = acc & vdb[blk[:, j]]
        out.append(tpopcount(acc).sum(dim=-1).to(torch.int32))
    if not out:
        return torch.zeros(0, dtype=torch.int32, device=vdb.device)
    return torch.cat(out)


def vertical_count(vdb: torch.Tensor, cand_idx: torch.Tensor) -> torch.Tensor:
    """(C,) int32 support counts from the vertical layout."""
    if _on_cpu(vdb, cand_idx):
        return vertical_count_plain(vdb, cand_idx)
    _check_vertical(vdb, cand_idx)
    C, kmax = cand_idx.shape
    out = torch.empty(C, dtype=torch.int32, device=vdb.device)
    if C:
        _build.launch("vertical_count", vdb.data_ptr(), vdb.shape[0],
                      vdb.shape[1], cand_idx.data_ptr(), C, kmax,
                      out.data_ptr())
    return out


# -- bit-plane matmul form -----------------------------------------------------

def vertical_membership(cand_idx: torch.Tensor, n_items: int,
                        n_cols: int | None = None):
    """(C, kmax) ids (sentinel ``n_items``) → 0/1 ``(C, n_cols)`` int8
    membership (columns ``≥ n_items`` zero; default ``n_cols = n_items``)
    and the distinct real items per row, (C,) int32."""
    C = cand_idx.shape[0]
    A = torch.zeros((C, n_items + 1), dtype=torch.int8, device=cand_idx.device)
    A.scatter_(1, cand_idx.to(torch.int64), 1)
    A = A[:, :n_items]                        # drop the sentinel column
    nreal = A.sum(dim=1, dtype=torch.int32)
    if n_cols is not None and n_cols > n_items:
        A = torch.nn.functional.pad(A, (0, n_cols - n_items))
    return A.contiguous(), nreal


@full_float32
def vertical_count_matmul_plain(vdb: torch.Tensor, cand_idx: torch.Tensor,
                                block: int = DEFAULT_MATMUL_BLOCK
                                ) -> torch.Tensor:
    """Plain version of :func:`vertical_count_matmul`: the presence counts
    are a float32 product, exact because the operands are 0/1 and a sum is
    at most I < 2²⁴ (torch's int8 matmul would wrap)."""
    n_items = vdb.shape[0] - 1
    vbits = tunpack_bits(vdb)                                 # (I+1, Tn)
    items = vbits[:n_items].to(torch.float32)
    valid = vbits[n_items] > 0
    out = []
    for s in range(0, cand_idx.shape[0], block):
        A, nreal = vertical_membership(cand_idx[s:s + block], n_items)
        present = A.to(torch.float32) @ items                 # (b, Tn)
        match = (present == nreal[:, None].to(torch.float32)) & valid
        out.append(match.sum(dim=1, dtype=torch.int32))
    if not out:
        return torch.zeros(0, dtype=torch.int32, device=vdb.device)
    return torch.cat(out)


def vertical_count_matmul(vdb: torch.Tensor,
                          cand_idx: torch.Tensor) -> torch.Tensor:
    """(C,) int32 support counts, membership-matmul form."""
    if _on_cpu(vdb, cand_idx):
        return vertical_count_matmul_plain(vdb, cand_idx)
    _check_vertical(vdb, cand_idx)
    C = cand_idx.shape[0]
    out = torch.empty(C, dtype=torch.int32, device=vdb.device)
    if C:
        _build.launch("vertical_count_matmul", vdb.data_ptr(),
                      vdb.shape[0] - 1, vdb.shape[1], cand_idx.data_ptr(), C,
                      cand_idx.shape[1], out.data_ptr())
    return out
