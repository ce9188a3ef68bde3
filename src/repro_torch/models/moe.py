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
combined with the renormalised top-k gates (no capacity, no drops).

Expert parallelism: with a mesh in ``ctx``, ``moe_apply`` takes the
reference's condition (``B % data``, ``S % model`` and ``E_pad % model``
all zero) to the expert-parallel path, :func:`_moe_apply_ep`: tokens
sharded (batch → data axes, sequence → model axis), each process routes
its own tokens into a capacity buffer of its own (capacity per *source*
process, as the reference's), two ``all_to_all`` over the model axis carry
the buffers to the experts' owners and back, and the load-balancing loss
is the mean of the processes' local losses.  Otherwise it runs the global
path on the gathered tokens and experts (the same numbers as one device).
Each MoE module counts its EP dispatches (``ep_dispatches``).  The dense
decode shards the experts over the model axis and sums the processes'
partial combines.

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

import types
from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import Partial, Replicate

from repro_torch.sharding import (NULL_CTX, all_to_all, axis_names,
                                  axis_sizes, local_offset, placements_for,
                                  run_local, shard_dims)

from .layers import _on_dims, _param, dense_init, silu


class MoE(nn.Module):
    """``router`` (d, E_pad) in float32; ``w_gate``/``w_up`` (E_pad, d, f)
    and ``w_down`` (E_pad, f, d) in the config dtype — the reference's
    ``moe`` keys.  ``pad`` marks the padded experts (a buffer, so a decode
    step uploads nothing).  ``ep_dispatches`` counts the calls that took
    the expert-parallel path."""
    AXES = {"router": (None, None),
            "w_gate": ("experts", "embed", "expert_mlp"),
            "w_up": ("experts", "embed", "expert_mlp"),
            "w_down": ("experts", "expert_mlp", "embed")}

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
        self.ep_dispatches = 0

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


def moe_apply(p: MoE, x: torch.Tensor, cfg, ctx=NULL_CTX):
    """Routed MoE FFN (prefill, training). x: (B, S, D) → (out (B, S, D),
    aux loss (scalar f32, Switch-style load balancing)).  With a mesh in
    ``ctx`` and divisible shapes, the expert-parallel path; with a mesh
    otherwise, the global path on gathered tensors."""
    if ctx.on:
        sizes = axis_sizes(ctx.mesh)
        data_ax = ("pod", "data") if "pod" in sizes else ("data",)
        dsize = int(np.prod([sizes.get(a, 1) for a in data_ax]))
        msize = sizes.get("model", 1)
        B, S, _ = x.shape
        if (B % dsize == 0 and S % msize == 0
                and cfg.experts_padded % msize == 0):
            return _moe_apply_ep(p, x, cfg, ctx, data_ax)
        return _moe_apply_gathered(p, x, cfg, ctx)
    return _moe_global(p, x, cfg)


def _moe_global(p, x: torch.Tensor, cfg):
    """The single-device path (global capacity); ``p`` has the MoE's
    tensors as attributes."""
    B, S, D = x.shape
    T, E, k = B * S, cfg.experts_padded, cfg.top_k
    xf = x.reshape(T, D)
    probs, w, idx = _route(p, xf, cfg)
    me = probs.mean(dim=0)
    ce = torch.zeros(E, dtype=torch.float32, device=x.device).scatter_add_(
        0, idx.reshape(-1), torch.ones(T * k, device=x.device)) / (T * k)
    aux = (me * ce).sum() * (cfg.n_experts ** 2) / cfg.n_experts
    return _dispatch_combine(p, xf, w, idx, cfg).reshape(B, S, D), aux


def _dispatch_combine(p, xf, w, idx, cfg, exchange=None):
    """Capacity buffer, experts and combine for tokens xf (T, D) routed to
    ``idx`` with weights ``w``.  ``exchange`` (expert parallelism) carries
    the (E, C, D) buffer to the experts' owners and returns the function
    that carries their output back; None runs every expert here."""
    T, D = xf.shape
    E, k = cfg.experts_padded, cfg.top_k
    d = dispatch(w, idx, cfg)
    # each kept assignment owns its (expert, rank) slot; the dropped ones
    # all write a spare slot past capacity, which is cut off unread
    rank = torch.where(d.keep, d.rank, d.cap)
    buf = torch.zeros((E, d.cap + 1, D), dtype=xf.dtype, device=xf.device)
    buf[d.expert, rank] = xf[d.token]
    buf = buf[:, :d.cap]
    if exchange is None:
        out = _experts(p, buf)
    else:
        recv, back = exchange(buf)
        out = back(_experts(p, recv))
    gathered = out[d.expert, torch.where(d.keep, d.rank, 0)]
    contrib = gathered * (d.weight * d.keep).to(xf.dtype)[:, None]
    # the reference's scatter-add of a token's contributions into zeros,
    # in increasing expert id: a token's sorted positions, ascending, are
    # its experts in that order (they are distinct)
    c = contrib[torch.sort(d.where, dim=1).values]     # (T, k, D)
    y = c[:, 0]
    for j in range(1, k):
        y = y + c[:, j]
    return y


def _tensors(p: MoE, **local) -> types.SimpleNamespace:
    """The MoE's tensors for a region (``local`` overrides), with its
    padded-expert mask."""
    out = {"router": p.router, "w_gate": p.w_gate, "w_up": p.w_up,
           "w_down": p.w_down, "pad": p.pad}
    out.update(local)
    return types.SimpleNamespace(**out)


def _moe_apply_ep(p: MoE, x, cfg, ctx, data_ax):
    """Expert-parallel dispatch on each process's shards (GShard-style).

    Tokens are sharded (batch → data axes, sequence → model axis); each
    process routes its tokens, builds a per-(process, expert) capacity
    buffer, exchanges it with two ``all_to_all`` over the model axis
    around the expert FFN, and combines locally.  Capacity is per source
    process; the aux loss is the mean of the processes' local losses."""
    mesh = ctx.mesh
    names = axis_names(mesh)
    xpl = placements_for(mesh, (data_ax if len(data_ax) > 1 else data_ax[0],
                                "model", None))
    wpl = placements_for(mesh, ("model", None, None))
    rep = [Replicate() for _ in names]
    E, k = cfg.experts_padded, cfg.top_k
    world = mesh.size()
    group = mesh.get_group("model")
    msize = mesh.size(names.index("model"))

    def exchange(buf):
        # route to expert owners: (E, cap, D) → (E/m, m·cap, D)
        El, cap, D = E // msize, buf.shape[1], buf.shape[2]
        recv = all_to_all(buf, group, msize)
        recv = recv.view(msize, El, cap, D).transpose(0, 1).reshape(
            El, msize * cap, D)

        def back(out):
            # (E/m, m·cap, D) → (E, cap, D)
            send = out.view(El, msize, cap, D).transpose(0, 1).reshape(
                E, cap, D)
            return all_to_all(send, group, msize)
        return recv, back

    def body(xl, router, w_gate, w_up, w_down):
        Bl, Sl, D = xl.shape
        T = Bl * Sl
        xf = xl.reshape(T, D)
        loc = _tensors(p, router=router, w_gate=w_gate, w_up=w_up,
                       w_down=w_down)
        probs, w, idx = _route(loc, xf, cfg)
        me = probs.mean(dim=0)
        ce = torch.zeros(E, dtype=torch.float32, device=xf.device) \
            .scatter_add_(0, idx.reshape(-1),
                          torch.ones(T * k, device=xf.device)) / (T * k)
        aux_local = (me * ce).sum() * cfg.n_experts
        y = _dispatch_combine(loc, xf, w, idx, cfg,
                              exchange if msize > 1 else None)
        return y.reshape(Bl, Sl, D), aux_local / world

    p.ep_dispatches += 1
    y, aux = run_local(body, mesh, xpl,
                       [(x, xpl), (p.router, rep), (p.w_gate, wpl),
                        (p.w_up, wpl), (p.w_down, wpl)],
                       [xpl, [Partial() for _ in names]])
    return y, aux.redistribute(mesh, rep).to_local()


def _moe_apply_gathered(p: MoE, x, cfg, ctx):
    """The global path with a mesh whose shapes do not divide: tokens and
    experts gathered, every process computing the one-device result."""
    mesh = ctx.mesh
    rep = [Replicate() for _ in axis_names(mesh)]

    def body(xl, router, w_gate, w_up, w_down):
        return _moe_global(_tensors(p, router=router, w_gate=w_gate,
                                    w_up=w_up, w_down=w_down), xl, cfg)

    y, aux = run_local(body, mesh, rep,
                       [(x, rep), (p.router, rep), (p.w_gate, rep),
                        (p.w_up, rep), (p.w_down, rep)], [rep, rep])
    return y, aux.to_local()


def moe_apply_dense(p: MoE, x: torch.Tensor, cfg, ctx=NULL_CTX):
    """No-drop MoE for decode steps: every expert on every token, combined
    with the renormalised top-k gates.  x: (B, S, D) with small B·S.
    With a mesh each process runs the experts it holds (("experts", None,
    None)) and the float32 combines are summed over the expert axis's
    mesh dimensions before the cast."""
    if ctx.on:
        return _moe_dense_sharded(p, x, cfg, ctx)
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


def _moe_dense_sharded(p: MoE, x, cfg, ctx):
    mesh = ctx.mesh
    x = ctx.constrain(x, ("batch", None, None))
    xpl = list(x.placements)
    wpl = ctx.placements(("experts", None, None), p.w_gate.shape)
    wpl = [q if q.is_shard() else Replicate() for q in wpl]
    edims = shard_dims(wpl, 0)
    rep = [Replicate() for _ in xpl]
    out = [Partial() if m in edims else q for m, q in enumerate(xpl)]

    def body(xl, router, w_gate, w_up, w_down):
        B, S, D = xl.shape
        T, E = B * S, cfg.experts_padded
        xf = xl.reshape(T, D)
        _, w, idx = _route(_tensors(p, router=router), xf, cfg)
        gates = torch.zeros((T, E), dtype=torch.float32,
                            device=xl.device).scatter_(1, idx, w)
        El = w_gate.shape[0]
        e0 = local_offset(mesh, wpl, 0, El)
        y_all = _experts(_tensors(p, w_gate=w_gate, w_up=w_up,
                                  w_down=w_down),
                         xf.unsqueeze(0).expand(El, T, D))
        y = torch.einsum("etd,te->td", y_all.float(), gates[:, e0:e0 + El])
        return y.reshape(B, S, D)

    y = run_local(body, mesh, xpl,
                  [(x, xpl), (p.router, rep), (p.w_gate, wpl),
                   (p.w_up, wpl), (p.w_down, wpl)], [out])
    return y.redistribute(mesh, xpl).to(x.dtype)


def n_dropped(p: MoE, x: torch.Tensor, cfg) -> int:
    """Assignments the routed path drops for x (B, S, D): a host count,
    for tests and reports, never on the serving path."""
    _, w, idx = _route(p, x.reshape(-1, x.shape[-1]), cfg)
    return int((~dispatch(w, idx, cfg).keep).sum())


