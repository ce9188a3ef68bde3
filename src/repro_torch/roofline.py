"""Measured-ops basis, counting-kernel roofline terms and the analytic LM
roofline for the port.

The port's copy of the JAX package's ``roofline.py``, less its HLO text
parsing: ``XFER_OPS_PER_BYTE`` and ``count_job_ops`` (the cost model's ops
basis, DESIGN.md §9), ``count_kernel_roofline`` (the achieved-vs-peak span
attributes of each counting job, DESIGN.md §10/§13), the analytic
accounting of an LM step — ``analytic_flops``, ``analytic_bytes``,
``RooflineTerms``, ``roofline_terms`` and ``predicted_vs_achieved`` — whose
expressions are the reference's, and :class:`CollectiveTally`, the
counterpart of the reference's ``parse_collectives``: where the reference
reads a compiled step's HLO, the tally watches a step run (on real tensors,
or traced on fake ones over a fake process group) and counts its
collectives by op with the reference's ``_comm_factor``, its FLOPs, the
bytes its ops touch and its peak of live memory.  The hardware is the
H100's (:data:`HW`), never the reference's TPU table.
"""

from __future__ import annotations

import dataclasses
import time
import weakref

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode, is_traceable_wrapper_subclass_type)

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
    (:data:`HW` by default), ``dominant`` taken over all three.  With
    ``collective_per_chip_bytes`` None (a record of the analytic dry run
    the port had before it traced steps) the collective term is None and
    ``dominant`` is taken over compute and memory only."""
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


# -- collectives, FLOPs and memory of a step as it runs -------------------------------

def _comm_factor(op: str, g: int) -> float:
    """Per-chip communicated bytes as a multiple of the tensor bytes (ring)."""
    if g <= 1:
        return 0.0
    if op == "all-gather":
        return (g - 1) / g
    if op == "all-reduce":
        return 2 * (g - 1) / g
    if op == "reduce-scatter":
        return (g - 1) / g
    if op == "all-to-all":
        return (g - 1) / g
    if op == "collective-permute":
        return 1.0
    return 1.0


# a collective op's name (``_c10d_functional::all_gather_into_tensor``,
# ``c10d::_allgather_base_`` ...) → the reference's HLO family, by the
# first fragment its name holds
_FAMILIES = (("reduce_scatter", "reduce-scatter"),
             ("allgather", "all-gather"), ("all_gather", "all-gather"),
             ("allreduce", "all-reduce"), ("all_reduce", "all-reduce"),
             ("alltoall", "all-to-all"), ("all_to_all", "all-to-all"),
             ("send", "collective-permute"), ("recv", "collective-permute"),
             ("broadcast", "broadcast"))
_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd", "c10d")


def collective_family(func) -> str | None:
    """The reference's family of a collective op (``all-gather``,
    ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute``), ``broadcast`` for c10d's, None for any other
    op (``wait_tensor`` included)."""
    ns, _, name = func.name().partition("::")
    if ns not in _COLLECTIVE_NS:
        return None
    for frag, family in _FAMILIES:
        if frag in name:
            return family
    return None


def _tensors(x):
    """The tensors of an op's argument or result (lists and tuples
    flattened)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _group_size(func, args, kwargs) -> int:
    """The size of the process group a collective runs over: its
    ``group_name`` (functional collectives) or ``process_group`` (c10d)
    argument."""
    from torch.distributed import distributed_c10d as c10d
    for i, a in enumerate(func._schema.arguments):
        if a.name not in ("group_name", "process_group"):
            continue
        g = kwargs[a.name] if a.name in kwargs else args[i]
        if isinstance(g, str):
            g = c10d._resolve_process_group(g)
        elif isinstance(g, torch.ScriptObject):
            g = c10d.ProcessGroup.unbox(g)
        return int(g.size())
    raise ValueError(f"{func.name()} names no process group")


# the ops that only read a tensor's metadata
_METADATA = {"aten::size", "aten::sym_size", "aten::stride",
             "aten::sym_stride", "aten::storage_offset",
             "aten::sym_storage_offset", "aten::numel", "aten::sym_numel",
             "aten::dim", "aten::is_contiguous", "aten::sym_is_contiguous",
             "aten::is_strides_like_format",
             "aten::is_non_overlapping_and_dense"}
_KINDS: dict = {}


def _op_kind(func) -> tuple:
    """What :class:`CollectiveTally` does with ``func``, worked out once:
    (its FLOP formula or None, its collective family or None, "op",
    "view" or None where it only reads metadata, whether it is an aten
    composite to count as the ops it is made of)."""
    from torch.utils.flop_counter import flop_registry
    count = flop_registry.get(func._overloadpacket)
    if func.namespace == "prim" or func.name() in _METADATA:
        return None, None, None, False
    composite = count is None and func.namespace == "aten" and \
        torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)
    return (count, collective_family(func), "view" if func.is_view else "op",
            composite)


def _storage_key(t: torch.Tensor):
    return t.untyped_storage()._cdata


class CollectiveTally(TorchDispatchMode):
    """Counts what a step does, on this process, as it runs — on real
    tensors, or traced on fake ones (``FakeTensorMode``) over a fake
    process group: the port's counterpart of the reference's
    ``parse_collectives`` and ``cost_analysis``/``memory_analysis``.

    * ``by_op`` / ``counts``: every collective the step issues — the
      functional forms DTensor uses and the c10d forms (``dist.*``) — by
      the reference's families, its bytes counted as the reference
      counts them: the bytes of the collective's result (the first
      argument of an in-place c10d op) times ``_comm_factor(family,
      size of the op's own group)``.  A collective run again (the
      recomputed forward of a remat'd block in backward) counts again, as
      XLA's HLO holds it twice.  ``per_chip_bytes`` is their sum.
    * ``flops``: ``torch.utils.flop_counter``'s count of the ops it
      registers (matrix products, convolutions and attention only; an
      elementwise op counts 0), on this process's shards — what
      ``FlopCounterMode`` counts of the same ops.
    * ``bytes_accessed``: the sum over the step's aten ops (views left
      out) of their input and output shard bytes: unfused eager traffic,
      not XLA's fused count.
    * ``peak_bytes``: the peak of live bytes held in storages the step
      allocated (its arguments are not counted; what it returns is, while
      it lives): the counterpart of XLA's temp bytes.

    An op on a tensor subclass (DTensor) is let through to the subclass,
    so the tally sees the local ops and collectives it turns into.
    """

    def __init__(self):
        super().__init__()
        self.by_op: dict = {}
        self.counts: dict = {}
        self.flops = 0
        self.bytes_accessed = 0
        self.live = 0
        self.peak_bytes = 0
        self._held: dict = {}
        self._quiet = 0
        self._entered = 0        # the mode enters itself again to decompose
        self._unwrap = None

    def __enter__(self):
        if not self._entered:
            self._quiet_propagation()
        self._entered += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._entered -= 1
            if not self._entered:
                self._unwrap()

    def _quiet_propagation(self) -> None:
        """DTensor runs each op once more on global-shape fake stand-ins to
        learn its output's shape (and caches that by op and placements):
        not the step's work, and absent from a second identical step, so
        the tally is quiet while it runs (until the outermost exit)."""
        from torch.distributed.tensor._sharding_prop import (
            ShardingPropagator)
        orig = ShardingPropagator._propagate_tensor_meta_non_cached

        def quiet(*args, **kwargs):
            self._quiet += 1
            try:
                return orig(*args, **kwargs)
            finally:
                self._quiet -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = quiet
        self._unwrap = lambda: setattr(
            ShardingPropagator, "_propagate_tensor_meta_non_cached", orig)

    @property
    def per_chip_bytes(self) -> float:
        return float(sum(self.by_op.values()))

    def _free(self, key) -> None:
        self.live -= self._held.pop(key, 0)

    def _hold(self, out, args, kwargs) -> None:
        seen = {_storage_key(t) for t in _tensors(args)}
        seen.update(_storage_key(t) for t in _tensors(list(kwargs.values())))
        for t in _tensors(out):
            key = _storage_key(t)
            if key in seen or key in self._held:
                continue
            seen.add(key)
            st = t.untyped_storage()
            self._held[key] = st.nbytes()
            self.live += st.nbytes()
            weakref.finalize(st, self._free, key)
        self.peak_bytes = max(self.peak_bytes, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(map(is_traceable_wrapper_subclass_type, types)):
            return NotImplemented           # DTensor: see what it runs
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        kind = _KINDS.get(func)
        if kind is None:
            kind = _KINDS[func] = _op_kind(func)
        count, family, counted, composite = kind
        if not counted or self._quiet:     # .size(); shape propagation
            return func(*args, **kwargs)
        if composite:
            # a composite op (under inference mode matmul and einsum come
            # here whole): count the ops it is made of, as FlopCounterMode
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if family is not None:
            result = args[0] if func.namespace == "c10d" else out
            b = sum(t.numel() * t.element_size() for t in _tensors(result))
            g = _group_size(func, args, kwargs)
            self.counts[family] = self.counts.get(family, 0) + 1
            self.by_op[family] = self.by_op.get(family, 0.0) + \
                b * _comm_factor(family, g)
        if count is not None:
            self.flops += int(count(*args, **kwargs, out_val=out))
        if counted == "op":                 # views move no bytes
            self.bytes_accessed += sum(
                t.numel() * t.element_size()
                for t in _tensors((args, list(kwargs.values()), out)))
            self._hold(out, args, kwargs)
        return out

    def record(self) -> dict:
        """The dry run's fields (the reference's record keys)."""
        return {"collectives_by_op": {k: int(v) for k, v in
                                      sorted(self.by_op.items())},
                "collective_counts": dict(sorted(self.counts.items())),
                "collective_per_chip_bytes": int(self.per_chip_bytes),
                "hlo_flops_raw": float(self.flops),
                "hlo_bytes_raw": float(self.bytes_accessed),
                "temp_bytes_per_dev": int(self.peak_bytes)}


def tally_step(fn) -> tuple:
    """Run ``fn()`` under a :class:`CollectiveTally`; returns (its result,
    the tally's :meth:`~CollectiveTally.record` with ``trace_s``, the
    seconds it took)."""
    t0 = time.perf_counter()
    with CollectiveTally() as tally:
        out = fn()
    rec = tally.record()
    rec["trace_s"] = time.perf_counter() - t0
    return out, rec
