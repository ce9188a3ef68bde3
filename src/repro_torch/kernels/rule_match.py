"""Rule scoring for serving: CUDA kernels and their plain PyTorch versions.

Rule antecedents play the candidates and query baskets the transactions of
the support-count subset test (DESIGN.md §7), but instead of reducing over
the baskets the kernels emit the full masked score matrix

    out[q, r] = score[r]  if ante[r] ⊆ basket[q]
                          (and, with ``exclude_contained``, cons[r] ⊄ basket[q])
                -inf      otherwise

for ``(R, W)`` antecedent and consequent masks and ``(Q, W)`` baskets held
as int32 words, and ``(R,)`` float32 scores.  Two formulations, as in the
JAX package:

* :func:`rule_scores` — the popcount-AND word loop; kernel ``rule_scores``
  in ``csrc/rule_match.cu`` (replaces ``rule_match.py:_rule_scores_kernel``);
* :func:`rule_scores_matmul` — the overlap form: ante ⊆ basket iff the
  overlap equals the antecedent's popcount, and cons ⊄ basket iff the
  consequent overlap differs from its popcount; kernel
  ``rule_scores_matmul`` (replaces
  ``rule_match.py:_rule_scores_matmul_kernel``), which takes the overlaps
  from the single-bit tensor cores straight from the packed words and
  counts the popcounts itself.  Its plain version unpacks bit planes and
  multiplies them, as the reference does.

Each wrapper runs its plain version when its tensors lie on the CPU and
launches its kernel when they lie on a card.  Both forms select the same
float32 score bits, so their outputs are identical.
"""

from __future__ import annotations

import torch

from repro_torch.core.bitset import tpopcount_rows, tunpack_bits

from . import _build
from .support_count import (_on_cpu, check_words, full_float32,
                            rows_per_chunk)

MAX_QUERIES = 65535 * 64        # both kernels' grids: 64 baskets a block row


def _select(ok: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    return torch.where(ok, scores[None, :],
                       torch.tensor(float("-inf"), device=scores.device))


def _check(antes, cons, scores, baskets) -> int:
    device = antes.device
    for name, t in (("antes", antes), ("cons", cons), ("baskets", baskets)):
        check_words(name, t, device)
    R, W = antes.shape
    if cons.shape != antes.shape or baskets.shape[1] != W:
        raise ValueError(f"shapes differ: antes {tuple(antes.shape)}, cons "
                         f"{tuple(cons.shape)}, baskets "
                         f"{tuple(baskets.shape)}")
    if (scores.dtype != torch.float32 or scores.shape != (R,)
            or not scores.is_contiguous() or scores.device != device):
        raise ValueError(f"scores must be a contiguous ({R},) float32 tensor "
                         f"on {device}")
    if baskets.shape[0] > MAX_QUERIES:
        raise ValueError(f"at most {MAX_QUERIES} baskets a call, got "
                         f"{baskets.shape[0]}")
    return W


# -- popcount-AND form ---------------------------------------------------------

def rule_scores_plain(antes: torch.Tensor, cons: torch.Tensor,
                      scores: torch.Tensor, baskets: torch.Tensor,
                      exclude_contained: bool = True,
                      q_block: int | None = None) -> torch.Tensor:
    """Plain version of :func:`rule_scores`: chunks of ``q_block`` baskets
    (default: about 2²⁴ tested words a chunk), ``(q_block, R, W)`` subset
    tests each."""
    R, W = antes.shape
    Q = baskets.shape[0]
    qb = q_block or rows_per_chunk(R, W)
    out = torch.empty((Q, R), dtype=torch.float32, device=antes.device)
    a, c = antes[None], cons[None]
    for s in range(0, Q, qb):
        b = baskets[s:s + qb, None, :]
        ok = ((a & b) == a).all(dim=-1)
        if exclude_contained:
            ok &= ~((c & b) == c).all(dim=-1)
        out[s:s + qb] = _select(ok, scores)
    return out


def rule_scores(antes: torch.Tensor, cons: torch.Tensor, scores: torch.Tensor,
                baskets: torch.Tensor,
                exclude_contained: bool = True) -> torch.Tensor:
    """(Q, R) float32 masked rule scores, popcount-AND form."""
    if _on_cpu(antes, cons, scores, baskets):
        return rule_scores_plain(antes, cons, scores, baskets,
                                 exclude_contained)
    W = _check(antes, cons, scores, baskets)
    R, Q = antes.shape[0], baskets.shape[0]
    out = torch.empty((Q, R), dtype=torch.float32, device=antes.device)
    if Q and R:
        _build.launch("rule_scores", antes.data_ptr(), cons.data_ptr(),
                      scores.data_ptr(), R, baskets.data_ptr(), Q, W,
                      int(exclude_contained), out.data_ptr())
    return out


# -- bit-plane matmul form -----------------------------------------------------

@full_float32
def rule_scores_matmul_plain(antes: torch.Tensor, cons: torch.Tensor,
                             scores: torch.Tensor, baskets: torch.Tensor,
                             exclude_contained: bool = True,
                             q_block: int | None = None) -> torch.Tensor:
    """Plain version of :func:`rule_scores_matmul`.

    The overlaps are float32 products: exact, because the operands are 0/1
    and every sum is at most 32·W ≤ 2²⁴ (torch's int8 matmul would wrap).
    """
    R, W = antes.shape
    Q = baskets.shape[0]
    qb = q_block or rows_per_chunk(R, 1)
    ab = tunpack_bits(antes).to(torch.float32)            # (R, 32W)
    aw = tpopcount_rows(antes).to(torch.float32)          # (R,)
    cb = tunpack_bits(cons).to(torch.float32)
    cw = tpopcount_rows(cons).to(torch.float32)
    out = torch.empty((Q, R), dtype=torch.float32, device=antes.device)
    for s in range(0, Q, qb):
        bb = tunpack_bits(baskets[s:s + qb]).to(torch.float32)
        ok = (bb @ ab.T) == aw[None, :]
        if exclude_contained:
            ok &= (bb @ cb.T) != cw[None, :]
        out[s:s + qb] = _select(ok, scores)
    return out


def rule_scores_matmul(antes: torch.Tensor, cons: torch.Tensor,
                       scores: torch.Tensor, baskets: torch.Tensor,
                       exclude_contained: bool = True) -> torch.Tensor:
    """(Q, R) float32 masked rule scores, bit-plane matmul form."""
    if _on_cpu(antes, cons, scores, baskets):
        return rule_scores_matmul_plain(antes, cons, scores, baskets,
                                        exclude_contained)
    W = _check(antes, cons, scores, baskets)
    R, Q = antes.shape[0], baskets.shape[0]
    out = torch.empty((Q, R), dtype=torch.float32, device=antes.device)
    if Q and R:
        _build.launch("rule_scores_matmul", antes.data_ptr(), cons.data_ptr(),
                      scores.data_ptr(), R, baskets.data_ptr(), Q, W,
                      int(exclude_contained), out.data_ptr())
    return out
