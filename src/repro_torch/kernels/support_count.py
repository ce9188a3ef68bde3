"""Horizontal support counting: CUDA kernels and their plain PyTorch versions.

``count[i]`` is the number of transactions ``t_j`` with ``c_i ⊆ t_j``, for
``(C, W)`` candidate and ``(T, W)`` transaction bitmasks held as int32 words.
Two formulations, as in the JAX package (DESIGN.md §10):

* :func:`support_count` — the popcount-AND subset test
  ``AND_w((c & t) == c)``; kernel ``support_count`` in ``csrc/counting.cu``
  (replaces ``support_count.py:_support_count_kernel``);
* :func:`support_count_matmul` — the bit-plane form: with ``Cb``/``Tb`` the
  0/1 planes, ``overlap = Cb·Tbᵀ`` and ``c_i ⊆ t_j`` iff
  ``overlap[i, j] == popcount(c_i)``; kernel ``support_count_matmul``
  (replaces ``support_count.py:_support_count_matmul_kernel``).  The planes
  are unpacked by plain torch ops around the kernel, as the reference
  unpacks them outside its Pallas kernel.

Each wrapper runs its plain version when its tensors lie on the CPU and
launches its kernel when they lie on a card; it never falls back from one
to the other.  An empty candidate is contained in every transaction, so it
counts ``T`` — the reference's semantics after its zero-row correction.
"""

from __future__ import annotations

import torch

from repro_torch.core.bitset import tpopcount_rows, tunpack_bits

from . import _build

DEFAULT_TXN_BLOCK = 1024      # plain popcount form: transaction rows a chunk
DEFAULT_MATMUL_BLOCK = 2048   # plain matmul form: transaction rows a chunk
PLAIN_CHUNK_ELEMS = 1 << 24   # the rule and delta plain versions' chunk


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def rows_per_chunk(n_rows: int, width: int) -> int:
    """Rows of a chunk whose (rows, n_rows, width) test holds about
    ``PLAIN_CHUNK_ELEMS`` elements — the plain versions' memory bound."""
    return max(1, PLAIN_CHUNK_ELEMS // max(n_rows * width, 1))


def check_words(name: str, t: torch.Tensor, device, ndim: int = 2) -> None:
    """Raise unless ``t`` is a contiguous int32 tensor of ``ndim`` dims on
    ``device``, a card — what a kernel reads through a raw pointer."""
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 words, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if device.type != "cuda":
        raise ValueError(f"{name}: the kernels take CUDA tensors, got "
                         f"{device}")


def _check_pair(cands: torch.Tensor, txns: torch.Tensor) -> int:
    check_words("cands", cands, cands.device)
    check_words("txns", txns, cands.device)
    W = cands.shape[1]
    if txns.shape[1] != W:
        raise ValueError(f"word counts differ: cands W={W}, "
                         f"txns W={txns.shape[1]}")
    return W


# -- popcount-AND form ---------------------------------------------------------

def support_count_plain(cands: torch.Tensor, txns: torch.Tensor,
                        block: int = DEFAULT_TXN_BLOCK) -> torch.Tensor:
    """Plain version of :func:`support_count`: chunks of ``block``
    transaction rows, ``(C, block, W)`` subset tests each."""
    out = torch.zeros(cands.shape[0], dtype=torch.int32, device=cands.device)
    c = cands[:, None, :]
    for s in range(0, txns.shape[0], block):
        t = txns[None, s:s + block, :]
        out += ((c & t) == c).all(dim=-1).sum(dim=1, dtype=torch.int32)
    return out


def support_count(cands: torch.Tensor, txns: torch.Tensor) -> torch.Tensor:
    """(C,) int32 support counts, popcount-AND form."""
    if _on_cpu(cands, txns):
        return support_count_plain(cands, txns)
    W = _check_pair(cands, txns)
    C, T = cands.shape[0], txns.shape[0]
    out = torch.empty(C, dtype=torch.int32, device=cands.device)
    if C:
        _build.launch("support_count", cands.data_ptr(), txns.data_ptr(),
                      C, T, W, out.data_ptr())
    return out


# -- bit-plane matmul form -----------------------------------------------------

def support_count_matmul_plain(cands: torch.Tensor, txns: torch.Tensor,
                               block: int = DEFAULT_MATMUL_BLOCK
                               ) -> torch.Tensor:
    """Plain version of :func:`support_count_matmul`.

    torch's int8 matmul returns int8 and wraps, and CUDA has no int32
    matmul, so the overlap is a float32 product: exact here, because the
    operands are 0/1 and every sum is at most 32·W ≤ 2²⁴.
    """
    # TF32 keeps 10 mantissa bits, which cannot hold an overlap of up to 256
    # exactly; full float32 can
    torch.backends.cuda.matmul.allow_tf32 = False
    cb = tunpack_bits(cands).to(torch.float32)            # (C, 32W)
    widths = tpopcount_rows(cands).to(torch.float32)      # (C,)
    out = torch.zeros(cands.shape[0], dtype=torch.int32, device=cands.device)
    for s in range(0, txns.shape[0], block):
        tb = tunpack_bits(txns[s:s + block]).to(torch.float32)
        ov = cb @ tb.T                                    # (C, block)
        out += (ov == widths[:, None]).sum(dim=1, dtype=torch.int32)
    return out


def support_count_matmul(cands: torch.Tensor,
                         txns: torch.Tensor) -> torch.Tensor:
    """(C,) int32 support counts, bit-plane matmul form."""
    if _on_cpu(cands, txns):
        return support_count_matmul_plain(cands, txns)
    W = _check_pair(cands, txns)
    C, T = cands.shape[0], txns.shape[0]
    out = torch.empty(C, dtype=torch.int32, device=cands.device)
    if C:
        cb = tunpack_bits(cands)          # (C, 32W) int8 = (C, 8W) int32 words
        tb = tunpack_bits(txns)
        widths = tpopcount_rows(cands)
        _build.launch("support_count_matmul", cb.data_ptr(),
                      widths.data_ptr(), tb.data_ptr(), C, T, 8 * W,
                      out.data_ptr())
    return out
