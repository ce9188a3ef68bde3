"""Measured-ops basis, counting-kernel roofline terms and the analytic LM
roofline for the port.

The port's copy of the JAX package's ``roofline.py``, less its HLO half:
``XFER_OPS_PER_BYTE`` and ``count_job_ops`` (the cost model's ops basis,
DESIGN.md §9), ``count_kernel_roofline`` (the achieved-vs-peak span
attributes of each counting job, DESIGN.md §10/§13), and the analytic
accounting of an LM step — ``analytic_flops``, ``analytic_bytes``,
``RooflineTerms``, ``roofline_terms`` and ``predicted_vs_achieved`` — whose
expressions are the reference's.  The hardware is the H100's
(:data:`HW`), never the reference's TPU table.  The reference reads
per-chip collective bytes from the compiled HLO; the port has no HLO, so
``roofline_terms`` takes them where a caller has them and otherwise leaves
the collective term out.
"""

from __future__ import annotations

import dataclasses

# One NVIDIA H100 SXM5 (NVIDIA's data sheet, dense rates, at its 700 W
# limit; a card nvidia-smi reports as "NVIDIA H100 80GB HBM3"): 989 TFLOP/s
# bf16 on the tensor cores, 3.35 TB/s of HBM3, 450 GB/s a direction of
# NVLink 4.  A card capped below 700 W runs slower under load.
HW = {
    "peak_flops": 989e12,   # bf16 per card
    "hbm_bw": 3.35e12,      # bytes/s per card
    "link_bw": 450e9,       # bytes/s per card, one direction
}

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


def predicted_vs_achieved(predicted_s: float, achieved_s: float) -> dict:
    """One predicted-vs-measured comparison row (cost-model telemetry)."""
    ratio = predicted_s / achieved_s if achieved_s > 0 else float("inf")
    rel_err = (abs(predicted_s - achieved_s) / achieved_s
               if achieved_s > 0 else float("inf"))
    return {"predicted_s": float(predicted_s), "achieved_s": float(achieved_s),
            "ratio": float(ratio), "abs_rel_err": float(rel_err)}


# -- analytic FLOPs / bytes of an LM step ------------------------------------------

def analytic_flops(cfg, shape) -> dict:
    """Exact-form FLOP accounting for one step of the given kind."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    n_active = cfg.active_param_count()
    n_total = cfg.param_count()
    weight_flops_fwd = 2 * n_active * tokens

    # attention: 2·S_ctx·hd FLOPs per (token, head) for qk plus same for pv
    hd = cfg.resolved_head_dim
    n_attn_layers = sum(1 for i in range(cfg.n_layers)
                        if cfg.layer_kind(i) == "attn")
    n_attn_layers += cfg.n_encoder_layers
    if shape.kind == "decode":
        ctx_len = shape.seq_len
        attn_fwd = (4 * ctx_len * cfg.padded_heads * hd * n_attn_layers
                    * shape.global_batch)
    else:
        ctx_avg = shape.seq_len / 2
        attn_fwd = 4 * ctx_avg * cfg.padded_heads * hd * n_attn_layers * tokens

    # SSD: per token·head: intra-chunk ≈ 2·L·(N + hd) + state update 2·N·hd
    ssd_fwd = 0
    if cfg.ssm_state:
        from repro_torch.models.ssm import ssm_dims
        d_inner, H, Pd, N = ssm_dims(cfg)
        n_ssm = sum(1 for i in range(cfg.n_layers)
                    if cfg.layer_kind(i) == "ssm")
        if shape.kind == "decode":
            ssd_fwd = 2 * H * Pd * N * 2 * n_ssm * shape.global_batch
        else:
            L = 256
            ssd_fwd = (2 * L * (N + Pd) + 4 * N * Pd) * H * n_ssm * tokens

    fwd = weight_flops_fwd + attn_fwd + ssd_fwd
    if shape.kind == "train":
        total = 3 * fwd          # bwd ≈ 2× fwd
        # remat recompute: full policy re-runs the forward; "dots" saves
        # matmul outputs and only recomputes elementwise glue (~15%)
        total += fwd if getattr(cfg, "remat_policy", "full") == "full" \
            else 0.15 * fwd
        model_flops = 6 * n_active * tokens
    else:
        total = fwd
        model_flops = 2 * n_active * tokens
    return {"model_flops": float(model_flops), "total_flops": float(total),
            "fwd_flops": float(fwd), "tokens": tokens,
            "params_total": n_total, "params_active": n_active}


def analytic_bytes(cfg, shape, chips: int) -> float:
    """Per-step global HBM traffic (bytes), all chips combined."""
    n = cfg.param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    act_unit = tokens * cfg.d_model * 2  # bf16 residual
    layers = cfg.n_layers + cfg.n_encoder_layers
    if shape.kind == "train":
        # params read (fwd+bwd+remat) ×3, grads written, opt m/v read+write
        # f32, master update; remat-saved activations written+read
        weight_traffic = n * 2 * 3 + n * 2 + 4 * n * 4
        act_traffic = act_unit * layers * (2 + 10)  # saves + working set
        return float(weight_traffic + act_traffic)
    if shape.kind == "prefill":
        weight_traffic = n * 2
        act_traffic = act_unit * layers * 6
        return float(weight_traffic + act_traffic)
    # decode: whole weight set + KV cache read per token step
    hd = cfg.resolved_head_dim
    n_attn = sum(1 for i in range(cfg.n_layers)
                 if cfg.layer_kind(i) == "attn")
    kv_bytes = (2 * shape.seq_len * cfg.n_kv_heads * hd * n_attn
                * shape.global_batch * 2)
    return float(cfg.active_param_count() * 2 + kv_bytes)


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float | None
    dominant: str
    model_flops: float
    hlo_flops_raw: float | None
    useful_ratio: float

    def as_dict(self):
        return dataclasses.asdict(self)


def roofline_terms(cfg, shape, chips: int,
                   collective_per_chip_bytes: float | None,
                   hlo_flops_raw: float | None = 0.0,
                   hw: dict | None = None) -> RooflineTerms:
    """The three roofline terms of one step on ``chips`` devices of ``hw``
    (:data:`HW` by default).  With ``collective_per_chip_bytes`` None the
    collective term is None and ``dominant`` is taken over compute and
    memory only."""
    hw = HW if hw is None else hw
    fl = analytic_flops(cfg, shape)
    by = analytic_bytes(cfg, shape, chips)
    compute_s = fl["total_flops"] / (chips * hw["peak_flops"])
    memory_s = by / (chips * hw["hbm_bw"])
    terms = {"compute": compute_s, "memory": memory_s}
    collective_s = None
    if collective_per_chip_bytes is not None:
        collective_s = collective_per_chip_bytes / hw["link_bw"]
        terms["collective"] = collective_s
    dominant = max(terms, key=terms.get)
    useful = fl["model_flops"] / fl["total_flops"] if fl["total_flops"] \
        else 0.0
    return RooflineTerms(compute_s, memory_s, collective_s, dominant,
                         fl["model_flops"], hlo_flops_raw, useful)
