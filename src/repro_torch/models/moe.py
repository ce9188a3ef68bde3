"""Mixture-of-Experts FFN with sort-based (dropping) dispatch.

The port's copy of the single-device half of the JAX package's
``models/moe.py``.  Tokens are routed top-k, flattened to (T·k)
assignments, sorted by expert id, ranked within each expert's run, and
scattered into a dense ``(E, C, D)`` buffer (C = capacity); the expert
FFNs run as batched matmuls over the expert axis; results are gathered
back with routing weights.  Assignments beyond capacity are dropped.
Experts are padded to a multiple of 16 (``cfg.experts_padded``) with −inf
router logits, so a padded expert's probability is exactly 0 and it never
receives a token.

Decode steps take ``moe_apply_dense``: every expert on every token,
combined with the renormalised top-k gates (no capacity, no drops).  The
reference's expert-parallel path (``_moe_apply_ep``, the mesh branch of
``moe_apply``) waits for the port's sharding slice: ``moe_apply`` takes
no ctx.

Parity hazards, each held by a test in ``tests/test_torch_moe.py``:

* top-k ties: ``jax.lax.top_k`` takes equal values lowest index first and
  ``torch.topk`` promises no order, so :func:`_top_k` keeps the first k
  of a stable descending sort;
* drop order: the rank within an expert comes from a stable sort of the
  flattened (token, slot) assignments, and capacity counts ``E_pad``
  experts, so the same assignments are dropped (right-padding tokens of
  ragged prompts compete for capacity, as in the reference);
* the combine: the reference scatter-adds a token's k contributions into
  zeros in sorted order (increasing expert id), rounding in the model
  dtype at each add.  ``index_add_`` on CUDA is atomic, so its rounding
  order would change from run to run; :func:`moe_apply` un-sorts the
  contributions into ``(T, k, D)`` by expert id and adds them in that
  order, with no atomics;
* the dense decode writes its products as ``(E, T, D) @ (E, D, F)``
  batched matmuls, which read each expert's weights once in place (an
  einsum may permute ``w_gate`` into ``(D, E·F)`` and copy it a step).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from .layers import _param, dense_init, silu


class MoE(nn.Module):
    """``router`` (d, E_pad) in float32; ``w_gate``/``w_up`` (E_pad, d, f)
    and ``w_down`` (E_pad, f, d) in the config dtype — the reference's
    ``moe`` keys.  ``pad`` marks the padded experts (a buffer, so a decode
    step uploads nothing)."""

    def __init__(self, cfg, device):
        super().__init__()
        d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.experts_padded
        self.router = _param((d, e), cfg, device, dtype=torch.float32)
        self.w_gate = _param((e, d, f), cfg, device)
        self.w_up = _param((e, d, f), cfg, device)
        self.w_down = _param((e, f, d), cfg, device)
        self.register_buffer(
            "pad", torch.arange(e, device=device) >= cfg.n_experts,
            persistent=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        d, f = self.w_down.shape[2], self.w_down.shape[1]
        dense_init(self.router, generator)
        dense_init(self.w_gate, generator, scale=1.0 / np.sqrt(d))
        dense_init(self.w_up, generator, scale=1.0 / np.sqrt(d))
        dense_init(self.w_down, generator, scale=1.0 / np.sqrt(f))


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, equal values
    lowest index first (a stable descending sort, then the first k).

    Every router pick goes through here, looked up by name at each call:
    ``chip_smoke.py``'s ``RouteLog`` wraps it to record and to pin the
    picks, so a change to its name or signature must carry that along."""
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], idx[..., :k]


def _route(p: MoE, xf: torch.Tensor, cfg):
    """xf (T, D) → (probs (T, E) f32, renormalised top-k weights (T, k),
    expert ids (T, k))."""
    logits = xf.float() @ p.router
    if cfg.experts_padded > cfg.n_experts:
        logits = logits.masked_fill(p.pad, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    w, idx = _top_k(probs, cfg.top_k)
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    return probs, w, idx


def capacity(cfg, n_tokens: int) -> int:
    """Slots an expert gets for ``n_tokens`` routed tokens: the reference's
    ``max(4, ceil4(ceil(capacity_factor · T · k / E_pad)))``."""
    cap = int(np.ceil(cfg.capacity_factor * n_tokens * cfg.top_k
                      / cfg.experts_padded))
    return max(4, ((cap + 3) // 4) * 4)


class Dispatch(NamedTuple):
    """The routed assignments, sorted by expert id (stably, so within an
    expert in (token, slot) order): expert, weight, token and rank of each,
    whether it fits the expert's capacity, and where each (token, slot)
    assignment landed in the sorted order."""
    expert: torch.Tensor      # (T·k,)
    weight: torch.Tensor      # (T·k,) f32
    token: torch.Tensor       # (T·k,)
    rank: torch.Tensor        # (T·k,)
    keep: torch.Tensor        # (T·k,) bool
    where: torch.Tensor       # (T, k): sorted position of each assignment
    cap: int


def dispatch(w: torch.Tensor, idx: torch.Tensor, cfg) -> Dispatch:
    """Sort the (T, k) assignments by expert and rank them within each
    expert's run; those ranked at or past capacity are dropped."""
    T, k = idx.shape
    E = cfg.experts_padded
    fe = idx.reshape(-1)
    order = torch.sort(fe, stable=True).indices
    fe_s = fe[order]
    seg_start = torch.searchsorted(fe_s, torch.arange(E, device=fe.device))
    rank = torch.arange(T * k, device=fe.device) - seg_start[fe_s]
    cap = capacity(cfg, T)
    where = torch.empty_like(order)
    where[order] = torch.arange(T * k, device=fe.device)
    return Dispatch(fe_s, w.reshape(-1)[order], order // k, rank,
                    rank < cap, where.view(T, k), cap)


def _experts(p: MoE, buf: torch.Tensor) -> torch.Tensor:
    """The expert FFNs over the expert axis: buf (E, C, D) → (E, C, D), in
    the parameter dtype."""
    h = silu(torch.bmm(buf, p.w_gate)) * torch.bmm(buf, p.w_up)
    return torch.bmm(h, p.w_down)


def moe_apply(p: MoE, x: torch.Tensor, cfg):
    """Routed MoE FFN (prefill). x: (B, S, D) → (out (B, S, D), aux loss
    (scalar f32, Switch-style load balancing))."""
    B, S, D = x.shape
    T, E, k = B * S, cfg.experts_padded, cfg.top_k
    xf = x.reshape(T, D)
    probs, w, idx = _route(p, xf, cfg)
    me = probs.mean(dim=0)
    ce = torch.zeros(E, dtype=torch.float32, device=x.device).scatter_add_(
        0, idx.reshape(-1), torch.ones(T * k, device=x.device)) / (T * k)
    aux = (me * ce).sum() * (cfg.n_experts ** 2) / cfg.n_experts

    d = dispatch(w, idx, cfg)
    # each kept assignment owns its (expert, rank) slot; the dropped ones
    # all write a spare slot past capacity, which is cut off unread
    rank = torch.where(d.keep, d.rank, d.cap)
    buf = torch.zeros((E, d.cap + 1, D), dtype=x.dtype, device=x.device)
    buf[d.expert, rank] = xf[d.token]
    out = _experts(p, buf[:, :d.cap])
    gathered = out[d.expert, torch.where(d.keep, d.rank, 0)]
    contrib = gathered * (d.weight * d.keep).to(x.dtype)[:, None]
    # the reference's scatter-add of a token's contributions into zeros,
    # in increasing expert id: a token's sorted positions, ascending, are
    # its experts in that order (they are distinct)
    c = contrib[torch.sort(d.where, dim=1).values]     # (T, k, D)
    y = c[:, 0]
    for j in range(1, k):
        y = y + c[:, j]
    return y.reshape(B, S, D), aux


def moe_apply_dense(p: MoE, x: torch.Tensor, cfg) -> torch.Tensor:
    """No-drop MoE for decode steps: every expert on every token, combined
    with the renormalised top-k gates.  x: (B, S, D) with small B·S."""
    B, S, D = x.shape
    T, E = B * S, cfg.experts_padded
    xf = x.reshape(T, D)
    _, w, idx = _route(p, xf, cfg)
    # a token's k experts are distinct, so a scatter is the reference's add
    gates = torch.zeros((T, E), dtype=torch.float32,
                        device=x.device).scatter_(1, idx, w)
    y_all = _experts(p, xf.unsqueeze(0).expand(E, T, D))  # (E, T, D)
    y = torch.einsum("etd,te->td", y_all.float(), gates)
    return y.to(x.dtype).reshape(B, S, D)


def n_dropped(p: MoE, x: torch.Tensor, cfg) -> int:
    """Assignments the routed path drops for x (B, S, D): a host count,
    for tests and reports, never on the serving path."""
    _, w, idx = _route(p, x.reshape(-1, x.shape[-1]), cfg)
    return int((~dispatch(w, idx, cfg).keep).sum())


