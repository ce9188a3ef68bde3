"""Measured-ops basis and counting-kernel roofline terms for the port.

A copy of the counting half of the JAX package's ``roofline.py``:
``XFER_OPS_PER_BYTE`` and ``count_job_ops`` (the cost model's ops basis,
DESIGN.md §9) and ``count_kernel_roofline`` (the achieved-vs-peak span
attributes of each counting job, DESIGN.md §10/§13).  The reference's TPU
table and its HLO parsing have no counterpart here.
"""

from __future__ import annotations

# One device→host byte is priced at this many candidate-word comparisons, so
# impl/fusion decisions see the transfer cost of the result shapes they
# produce, not only the counting work (DESIGN.md §10).
XFER_OPS_PER_BYTE = 64.0


def count_job_ops(n_candidates: int, n_txns: int, n_words: int = 1,
                  bytes_to_host: float = 0.0) -> float:
    """Work of one support-counting job in the measured-ops basis: C·T·W
    candidate-word comparisons (each of C candidates tested against each of
    T transactions over W mask words), plus the job's device→host result
    traffic priced at ``XFER_OPS_PER_BYTE`` ops per byte."""
    ops = float(max(int(n_candidates), 1)) * max(int(n_txns), 1) * \
        max(int(n_words), 1)
    return ops + max(float(bytes_to_host), 0.0) * XFER_OPS_PER_BYTE


# Peaks per torch device type.  "cuda" is one NVIDIA H100 SXM at its full
# 700 W power limit (NVIDIA's data sheet, dense rates): 1,979 TOP/s int8 on
# the tensor cores and 3.35 TB/s of HBM3.  A card capped below 700 W runs
# slower under load, so report a peak fraction beside the card's power limit.
# "cpu" is one desktop-class socket, order of magnitude only.
COUNT_PEAKS = {
    "cpu": {"int8_ops": 2.0e12, "mem_bw": 50e9},
    "cuda": {"int8_ops": 1979e12, "mem_bw": 3.35e12},
}


def count_kernel_roofline(family: str, *, C: int, T: int, W: int = 1,
                          kmax: int = 1, seconds: float,
                          backend: str) -> dict:
    """Achieved-vs-peak terms for one counting job.

    Args:
      family: "matmul" (bit-plane dot form — any layout), "horizontal"
              (popcount subset scan) or "vertical" (popcount gather-AND).
      C/T/W/kmax: the job's shape (T = transaction rows).
      seconds: measured wall time of the job.
      backend: a key of :data:`COUNT_PEAKS` ("cuda" or "cpu").
    """
    peaks = COUNT_PEAKS[backend]
    s = max(float(seconds), 1e-12)
    if family == "matmul":
        # (C, W·32) × (W·32, T) int8 dot: 2 ops (mul+add) per MAC
        achieved = 2.0 * float(C) * T * W * 32 / s
        peak, bound, unit = peaks["int8_ops"], "compute", "int8_ops_per_s"
    elif family == "vertical":
        # each candidate gathers kmax item rows of T/32 words (4 B each)
        achieved = 4.0 * C * kmax * max(T / 32.0, 1.0) / s
        peak, bound, unit = peaks["mem_bw"], "memory", "bytes_per_s"
    else:                       # horizontal popcount subset scan
        # word loads for both operands + the (C, T) match matrix traffic
        achieved = (4.0 * W * (float(C) + T) + float(C) * T) / s
        peak, bound, unit = peaks["mem_bw"], "memory", "bytes_per_s"
    return {"family": family, "bound": bound, "unit": unit,
            "achieved": float(achieved), "peak": float(peak),
            "peak_frac": float(achieved / peak)}
