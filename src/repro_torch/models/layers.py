"""Foundational model layers: init helpers, RMSNorm, RoPE, GQA attention
(chunked flash-style for prefill, cache-based for decode), SwiGLU MLP.

The port's copy of the JAX package's ``models/layers.py``.  Parameters live
in ``nn.Module``s whose attribute names are the reference's parameter-tree
keys (``attn.wq``, ``mlp.w_gate``, ``embed.table`` ...), in the same shapes,
so ``convert.load_reference_params`` can carry a reference tree across
one-to-one.  The functions mirror the reference's arithmetic step by step:

* products run in the parameter dtype and round there (bf16 by default):
  ``_qkv``, the MLP, ``wo`` and the attention scores, which are cast to
  float32 only after the product and then scaled;
* the MLP's SiLU takes the reference's own ops in the parameter dtype;
* norms, softmax and P·V run in float32;
* RoPE's frequencies come from float64 numpy, cast to float32, and rotate
  the split halves of the head (not interleaved pairs).

Initialisation draws float32 normals from an explicit ``torch.Generator``
on the parameter's device, one tensor at a time, and casts them to the
parameter dtype.  It cannot reproduce the reference's ``jax.random``
draws; parity tests carry the reference's parameters across instead.

Parameters are built frozen (``requires_grad=False``), as serving wants
them; ``train.init_train_state`` makes a model's parameters trainable.

Sharding: each module's ``AXES`` names the logical axes of its parameters,
the reference's ``dense_init`` axes (the port keeps one module a layer, so
the reference's leading stacked ``"layers"`` axis is dropped).  Under
:func:`meta_params` the parameters are built on the ``meta`` device, so
``model.shard_params`` can place them on a mesh a shard at a time.  Every
function takes a ``ctx`` (``sharding.ShardCtx``): with a mesh the
parameters are DTensors, the reference's constraint sites redistribute,
the products run as DTensor ops, and the head-sharded attention core, the
rotary embedding and the decode cache writes run on each process's shards
(``sharding.run_local``).  Without one (``NULL_CTX``) every function is the
single-device code, unchanged.
Where autograd records (training), :func:`remat` rematerialises what the
reference wraps in ``jax.checkpoint``: each attention q-chunk here, each
SSD chunk (``ssm``), each loss chunk and, with ``cfg.remat``, each block
(``transformer``, ``encdec``).  Under ``torch.inference_mode`` (prefill,
decode) it is a plain call.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint, noop_context_fn

from repro_torch.sharding import (NULL_CTX, is_dtensor, local_offset,
                                  run_local, shard_dims)


def torch_dtype(cfg) -> torch.dtype:
    """The config's parameter dtype (``"bfloat16"``, ``"float32"`` ...)."""
    dt = getattr(torch, cfg.dtype, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {cfg.dtype!r}")
    return dt


def remat(fn, *args, context_fn=None):
    """``fn(*args)``, its activations recomputed in backward
    (``torch.utils.checkpoint``, non-reentrant; ``context_fn`` chooses what
    is saved) while autograd records; a plain call otherwise."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=context_fn or noop_context_fn)


_META = [False]


@contextlib.contextmanager
def meta_params():
    """Build parameters on the ``meta`` device (shapes only, no memory);
    buffers stay on the module's device."""
    _META[0] = True
    try:
        yield
    finally:
        _META[0] = False


def _param(shape, cfg, device, dtype=None) -> nn.Parameter:
    """An uninitialised parameter in the config's dtype (or ``dtype``)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype or torch_dtype(cfg),
                                    device="meta" if _META[0] else device),
                        requires_grad=False)


def draw_into(param: torch.Tensor, full: torch.Tensor) -> None:
    """Copy a freshly drawn full tensor into ``param``: the whole of it, or
    for a DTensor its shard (the rest is freed)."""
    if is_dtensor(param):
        from repro_torch.sharding import local_slice
        full = local_slice(full, param.device_mesh, param.placements)
        param.to_local().copy_(full)
    else:
        param.copy_(full)


@torch.no_grad()
def dense_init(param: torch.Tensor, generator: torch.Generator,
               scale: float | None = None) -> None:
    """Normal(0, scale) in float32, cast to the parameter's dtype; default
    scale = 1/sqrt(fan_in) with fan_in the first axis, as the reference.
    The draw is the whole parameter's on the generator's device, so a
    sharded parameter gets the same numbers as an unsharded one."""
    if scale is None:
        scale = 1.0 / np.sqrt(param.shape[0])
    draw_into(param, torch.randn(param.shape, generator=generator,
                                 dtype=torch.float32,
                                 device=generator.device).mul_(scale))


# -- norm ---------------------------------------------------------------------

class RMSNorm(nn.Module):
    AXES = {"scale": (None,)}

    def __init__(self, cfg, device):
        super().__init__()
        self.scale = _param((cfg.d_model,), cfg, device)

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(1)


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p.scale.float()).to(x.dtype)


def head_rmsnorm(scale: torch.Tensor, x: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """Per-head qk-norm over the head_dim axis."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# -- rotary -------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies computed in float64 numpy, then cast to float32
    (the reference's ``jnp.asarray(..., float32)``)."""
    freqs = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    return torch.as_tensor(freqs, dtype=torch.float32, device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               freqs: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S); freqs:
    ``rope_frequencies(hd, theta)`` on x's device.  Split-half rotation."""
    ang = positions[..., None].float() * freqs        # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -- attention ------------------------------------------------------------------

def head_mask(cfg, device=None) -> torch.Tensor:
    """(padded_heads,) f32 mask: 1 for real q heads, 0 for group padding.

    Padded q-head layout is (kv_head, group) flattened, so real heads are the
    first ``group_size`` of each ``padded_group_size`` group — GQA head→kv
    mapping is preserved exactly for real heads.
    """
    g = torch.arange(cfg.padded_heads, device=device) % cfg.padded_group_size
    return (g < cfg.group_size).float()


class Attention(nn.Module):
    """GQA attention parameters: ``wq`` (d, Hq_padded, hd), ``wk``/``wv``
    (d, Hkv, hd), ``wo`` (Hq_padded, hd, d), and ``q_norm``/``k_norm``
    (hd,) under qk-norm, which cross attention (``cross=True``) never
    takes.  The RoPE frequencies and the head mask are buffers on the
    module's device, so a decode step uploads nothing."""
    AXES = {"wq": ("embed", "q_heads", "head_dim"),
            "wk": ("embed", "kv_heads", "head_dim"),
            "wv": ("embed", "kv_heads", "head_dim"),
            "wo": ("q_heads", "head_dim", "embed"),
            "q_norm": ("head_dim",), "k_norm": ("head_dim",)}

    def __init__(self, cfg, device, cross: bool = False):
        super().__init__()
        d, hkv = cfg.d_model, cfg.n_kv_heads
        hq, hd = cfg.padded_heads, cfg.resolved_head_dim
        self.wq = _param((d, hq, hd), cfg, device)
        self.wk = _param((d, hkv, hd), cfg, device)
        self.wv = _param((d, hkv, hd), cfg, device)
        self.wo = _param((hq, hd, d), cfg, device)
        if cfg.qk_norm and not cross:
            self.q_norm = _param((hd,), cfg, device)
            self.k_norm = _param((hd,), cfg, device)
        self.register_buffer("freqs", rope_frequencies(hd, cfg.rope_theta,
                                                       device),
                             persistent=False)
        self.register_buffer("head_mask", head_mask(cfg, device),
                             persistent=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        hq, hd = self.wo.shape[:2]
        dense_init(self.wq, generator)
        dense_init(self.wk, generator)
        dense_init(self.wv, generator)
        dense_init(self.wo, generator, scale=1.0 / np.sqrt(hq * hd))
        if hasattr(self, "q_norm"):
            with torch.no_grad():
                self.q_norm.fill_(1)
                self.k_norm.fill_(1)


def _batch_only(x, avoid=()) -> list:
    """x's placements kept where they shard its batch (dimension 0) on a
    mesh dimension not in ``avoid``; replicated elsewhere."""
    return [pl if (pl.is_shard() and pl.dim == 0 and m not in avoid)
            else Replicate() for m, pl in enumerate(x.placements)]


def col_parallel(x, w):
    """``x @ w`` (w (D, F)) column-parallel on each process's shards: x
    gathered but for its batch, w gathered over D and kept split over F's
    mesh dimensions; the output is split like F (and x's batch)."""
    mesh = w.device_mesh
    fd = shard_dims(w.placements, 1)
    xpl = _batch_only(x, fd)
    wpl = _on_dims(w.placements, {1: 1})
    last = x.ndim - 1
    out = [xp if xp.is_shard() else
           (Shard(last) if m in fd else xp) for m, xp in enumerate(xpl)]
    return run_local(lambda a, b: a @ b, mesh, out, [(x, xpl), (w, wpl)],
                     [out])


def row_parallel(h, w):
    """``h @ w`` (w (F, D)) row-parallel: h split over F as it comes, w's
    rows split alike (D gathered); the partial sums are left ``Partial``
    over F's mesh dimensions."""
    last = h.ndim - 1
    hpl = list(h.placements)
    fd = shard_dims(hpl, last)
    wpl = _on_dims(hpl, {last: 0})
    out = [Partial() if m in fd else
           (pl if pl.is_shard() and pl.dim == 0 else Replicate())
           for m, pl in enumerate(hpl)]
    return run_local(lambda a, b: a @ b, w.device_mesh, hpl,
                     [(h, hpl), (w, wpl)], [out])


def lookup_rows(table, idx, ctx, idx_axes):
    """``table[idx]`` with a DTensor table: each process looks up the rows
    its slice of dimension 0 holds (0 elsewhere; the vocab-parallel
    embedding), the partial results left ``Partial`` over those mesh
    dimensions.  ``idx``: a full index tensor placed by ``idx_axes``."""
    mesh = ctx.mesh
    tpl = list(table.placements)
    vd = shard_dims(tpl, 0)
    wpl = _on_dims(tpl, {0: 0})
    ipl = [Replicate() if m in vd else pl
           for m, pl in enumerate(ctx.placements(idx_axes, idx.shape))]
    prim = _on_dims(ipl, {0: 0})
    out = [Partial() if m in vd else q for m, q in enumerate(prim)]

    def body(tl, il):
        n = tl.shape[0]
        r = il.long() - local_offset(mesh, wpl, 0, n)
        ok = (r >= 0) & (r < n)
        rows = tl[r.clamp(0, n - 1)]
        return torch.where(ok[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                            device=rows.device))

    return run_local(body, mesh, prim, [(table, wpl), (idx, ipl)], [out])


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk"), in the parameter dtype.  Sharded, it runs
    column-parallel on each process's shards: x gathered but for its batch,
    the weight gathered over embed and kept split over its heads' mesh
    dimensions, so each process computes its heads of its rows."""
    if not is_dtensor(w):
        return (x @ w.flatten(1)).unflatten(-1, w.shape[1:])
    mesh = w.device_mesh
    heads = shard_dims(w.placements, 1)
    wpl = _on_dims(w.placements, {1: 1})
    xpl = _batch_only(x, heads)
    out = [xp if xp.is_shard() else (Shard(2) if m in heads else xp)
           for m, xp in enumerate(xpl)]
    return run_local(
        lambda xl, wl: (xl @ wl.flatten(1)).unflatten(-1, wl.shape[1:]),
        mesh, out, [(x, xpl), (w, wpl)], [out])


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd"), in the parameter dtype.  Sharded, it runs
    row-parallel: each process's heads against their rows of ``wo``, the
    partial sums left ``Partial`` over the heads' mesh dimensions."""
    if not is_dtensor(wo):
        return o.flatten(-2) @ wo.flatten(0, 1)
    opl = list(o.placements)
    heads = shard_dims(opl, 2)
    wpl = _on_dims(opl, {2: 0})
    out = [Partial() if m in heads else
           (pl if pl.is_shard() and pl.dim == 0 else Replicate())
           for m, pl in enumerate(opl)]
    return run_local(lambda ol, wl: ol.flatten(-2) @ wl.flatten(0, 1),
                     wo.device_mesh, opl, [(o, opl), (wo, wpl)], [out])


def _qkv(p: Attention, x, kv_x, cfg, positions, kv_positions, rope: bool,
         ctx=NULL_CTX):
    q = _proj(x, p.wq)
    k = _proj(kv_x, p.wk)
    v = _proj(kv_x, p.wv)
    if hasattr(p, "q_norm"):
        q = head_rmsnorm(p.q_norm, q, cfg.norm_eps)
        k = head_rmsnorm(p.k_norm, k, cfg.norm_eps)
    rope = rope and cfg.use_rope
    masked = cfg.padded_heads != cfg.n_heads
    if ctx.on:
        if rope or masked:
            q = _heads_local(ctx, q, "q_heads", positions if rope else None,
                             p.freqs, p.head_mask if masked else None)
        if rope:
            k = _heads_local(ctx, k, "kv_heads", kv_positions, p.freqs, None)
        return q, k, v
    if rope:
        q = apply_rope(q, positions, p.freqs)
        k = apply_rope(k, kv_positions, p.freqs)
    if masked:
        q = q * p.head_mask[None, None, :, None].to(q.dtype)
    return q, k, v


def _on_dims(placements, dims: dict) -> list:
    """Placements for a lower-rank companion of a sharded tensor: where
    ``placements`` shard tensor dimension ``d`` in ``dims``, the companion
    is sharded on its dimension ``dims[d]``; elsewhere replicated."""
    return [Shard(dims[pl.dim]) if pl.is_shard() and pl.dim in dims
            else Replicate() for pl in placements]


def _heads_local(ctx, x, head_axis: str, positions, freqs, mask):
    """RoPE (``positions`` (B, S), a full tensor, or None) and the
    padded-head mask (``mask`` (H,) or None) of x (B, S, H, hd), on each
    process's shards: batch on its axis, heads on ``head_axis``."""
    pl = ctx.placements(("batch", None, head_axis, None), x.shape)

    def body(xl, pos, msk):
        if pos is not None:
            xl = apply_rope(xl, pos, freqs)
        if msk is not None:
            xl = xl * msk[None, None, :, None].to(xl.dtype)
        return xl

    return run_local(body, ctx.mesh, pl,
                     [(x, pl),
                      (positions, None if positions is None
                       else _on_dims(pl, {0: 0})),
                      (mask, None if mask is None else _on_dims(pl, {2: 0}))],
                     [pl])


def _divisor_chunk(n: int, chunk: int) -> int:
    """The largest size ≤ chunk that divides n (the reference's search)."""
    c = min(chunk, n)
    while n % c:
        c -= 1
    return c


def chunked_attention(q, k, v, n_kv_heads: int, causal: bool,
                      q_chunk: int = 512, kv_chunk: int = 1024,
                      q_offset: int = 0) -> torch.Tensor:
    """Flash-style streaming-softmax attention in plain torch.

    q: (B, S, Hq, hd); k, v: (B, T, Hkv, hd).  The reference's double
    ``lax.scan`` becomes two loops over chunks of sizes found by its divisor
    search, with its ``-inf`` guards for fully masked rows and its ``1e-30``
    clamp.  Causal masking uses absolute positions (q position = q_offset +
    index).  Scores are the product in q's dtype, cast to float32 and
    scaled; P·V runs in float32.  Each q-chunk is rematerialised in
    backward (:func:`remat`).
    """
    B, S, Hq, hd = q.shape
    T = k.shape[1]
    G = Hq // n_kv_heads
    scale = 1.0 / np.sqrt(hd)
    # GQA: broadcast KV to the flat q heads, as the reference does
    head_to_kv = torch.arange(Hq, device=q.device) // G
    k = k.index_select(2, head_to_kv)     # (B, T, Hq, hd)
    v = v.index_select(2, head_to_kv)

    qc = _divisor_chunk(S, q_chunk)
    kc = _divisor_chunk(T, kv_chunk)
    q_pos = q_offset + torch.arange(S, device=q.device)
    k_pos = torch.arange(T, device=q.device)

    def per_q_chunk(qck, k, v, qp):
        m = torch.full((B, Hq, qc), -torch.inf, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, Hq, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, Hq, qc, hd), dtype=torch.float32,
                          device=q.device)
        for ks in range(0, T, kc):
            kck, vck = k[:, ks:ks + kc], v[:, ks:ks + kc]
            kp = k_pos[ks:ks + kc]
            s = torch.einsum("bqhd,bkhd->bhqk", qck, kck).float() * scale
            if causal:
                mask = qp[:, None] >= kp[None, :]       # (qc, kc)
                s = torch.where(mask[None, None], s, -torch.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # guard: fully-masked rows have m == -inf
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p_ = torch.exp(s - m_safe[..., None])
            if causal:
                p_ = torch.where(mask[None, None], p_, 0.0)
            corr = torch.exp(torch.where(torch.isfinite(m), m - m_safe,
                                         -torch.inf))
            corr = torch.where(torch.isfinite(corr), corr, 0.0)
            l = l * corr + p_.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p_, vck.float())
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]  # (B, Hq, qc, hd)
        return out.transpose(1, 2)                       # (B, qc, Hq, hd)

    # each q-chunk rematerialised in backward, as the reference's
    # jax.checkpoint: the KV loop is streamed again instead of saving every
    # (qc, kc) probability tile
    outs = [remat(per_q_chunk, q[:, qs:qs + qc], k, v, q_pos[qs:qs + qc])
            for qs in range(0, S, qc)]
    return torch.cat(outs, dim=1).to(q.dtype)


def _attend(ctx, p: Attention, q, k, v, cfg, causal: bool):
    """The attention core with the padded-head mask after it.  With a mesh
    it runs head-sharded on each process's shards (the reference constrains
    q, k, v to ("batch", None, "q_heads", None) around it, so GSPMD shards
    heads rather than running attention replicated): k and v keep their kv
    heads, replicated where q's heads are sharded, and each process
    broadcasts the kv heads its q heads read."""
    masked = cfg.padded_heads != cfg.n_heads
    if not ctx.on:
        o = chunked_attention(q, k, v, cfg.n_kv_heads, causal=causal,
                              q_chunk=cfg.attn_q_chunk,
                              kv_chunk=cfg.attn_kv_chunk)
        if masked:
            o = o * p.head_mask[None, None, :, None].to(o.dtype)
        return o
    mesh = ctx.mesh
    pl = ctx.placements(("batch", None, "q_heads", None), q.shape)
    kpl = _on_dims(pl, {0: 0})
    G = cfg.padded_heads // cfg.n_kv_heads

    def body(ql, kl, vl, msk):
        h0 = local_offset(mesh, pl, 2, ql.shape[2])
        idx = (h0 + torch.arange(ql.shape[2], device=ql.device)) // G
        o = chunked_attention(ql, kl.index_select(2, idx),
                              vl.index_select(2, idx), ql.shape[2],
                              causal=causal, q_chunk=cfg.attn_q_chunk,
                              kv_chunk=cfg.attn_kv_chunk)
        if msk is not None:
            o = o * msk[None, None, :, None].to(o.dtype)
        return o

    return run_local(body, mesh, pl,
                     [(q, pl), (k, kpl), (v, kpl),
                      (p.head_mask if masked else None,
                       _on_dims(pl, {2: 0}) if masked else None)], [pl])


def attention_apply(p: Attention, x, cfg, positions, causal: bool = True,
                    kv_x=None, kv_positions=None, rope: bool = True,
                    ctx=NULL_CTX):
    """Full-sequence attention (prefill / encoder / cross): keys and values
    from ``kv_x`` at ``kv_positions`` (x and positions unless given).

    Returns (out (B,S,D), (k, v)) — k/v returned for cache construction.
    """
    kv_x = x if kv_x is None else kv_x
    kv_positions = positions if kv_positions is None else kv_positions
    q, k, v = _qkv(p, x, kv_x, cfg, positions, kv_positions, rope=rope,
                   ctx=ctx)
    o = _attend(ctx, p, q, k, v, cfg, causal)
    return _out_proj(o, p.wo), (k, v)


def cache_layer_placements(cache_placements) -> list:
    """A stacked (layers, ...) cache's placements → one layer's."""
    return [Shard(pl.dim - 1) if pl.is_shard() else pl
            for pl in cache_placements]


def write_cache(ctx, cache, slot: int, new, start: int = 0) -> None:
    """Write ``new`` (B, S, ...) into layer ``slot`` of a stacked cache
    (layers, B, T, ...) at positions ``start … start + S - 1``, in place;
    with a mesh each process writes the positions its shard holds."""
    S = new.shape[1]
    if not ctx.on:
        cache[slot, :, start:start + S] = new.to(cache.dtype)
        return
    mesh = ctx.mesh
    lpl = cache_layer_placements(cache.placements)
    npl = [pl if not (pl.is_shard() and pl.dim == 1) else Replicate()
           for pl in lpl]

    def body(cl, nl):
        T = cl.shape[2]
        off = local_offset(mesh, lpl, 1, T)
        lo, hi = max(start, off), min(start + S, off + T)
        if lo < hi:
            cl[slot, :, lo - off:hi - off] = nl[:, lo - start:hi - start].to(
                cl.dtype)

    run_local(body, mesh, lpl, [(cache, list(cache.placements)),
                                (new, npl)], [])


def attention_decode(p: Attention, x, cfg, cache_k, cache_v, pos,
                     ctx=NULL_CTX, slot: int | None = None):
    """Single-token decode. x: (B, 1, D); cache_{k,v}: (B, Smax, Hkv, hd);
    pos: (B,) — per-request current position (continuous batching).

    Writes ``cache[b, pos[b]]`` in place (the reference donates its caches)
    and takes the softmax over the whole cache under the mask ``t <= pos``.
    Returns out (B, 1, D).  With a mesh the caches are the stacked
    (layers, B, Smax, Hkv, hd) DTensors and ``slot`` the layer's index.
    """
    if ctx.on:
        return _attention_decode_sharded(p, x, cfg, ctx, cache_k, cache_v,
                                         slot, pos)
    B = x.shape[0]
    positions = pos[:, None]
    q, k, v = _qkv(p, x, x, cfg, positions, positions, rope=True)
    b_idx = torch.arange(B, device=x.device)
    cache_k[b_idx, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[b_idx, pos] = v[:, 0].to(cache_v.dtype)
    Hq, Hkv = cfg.padded_heads, cfg.n_kv_heads
    G = Hq // Hkv
    hd = q.shape[-1]
    # flat-head GQA (see chunked_attention): broadcast cached KV to q heads
    head_to_kv = torch.arange(Hq, device=x.device) // G
    ck = cache_k.index_select(2, head_to_kv)                 # (B, T, Hq, hd)
    cv = cache_v.index_select(2, head_to_kv)
    qf = q[:, 0]                                             # (B, Hq, hd)
    s = torch.einsum("bhd,bthd->bht", qf, ck).float() / np.sqrt(hd)
    t_idx = torch.arange(cache_k.shape[1], device=x.device)
    valid = t_idx[None, :] <= pos[:, None]                   # (B, T)
    s = torch.where(valid[:, None, :], s, -torch.inf)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bht,bthd->bhd", w, cv.float())
    o = o.reshape(B, 1, Hq, hd).to(x.dtype)
    if Hq != cfg.n_heads:
        o = o * p.head_mask[None, None, :, None].to(o.dtype)
    return _out_proj(o, p.wo)


def _attention_decode_sharded(p: Attention, x, cfg, ctx, cache_k, cache_v,
                              slot: int, pos):
    """The decode step on each process's cache shard.  q, the new k/v and
    the output take the cache's batch and kv-head sharding (a kv head's q
    heads are contiguous, so sharding kv heads shards q heads alike).
    Where the cache's sequence is sharded (the decode and long-context
    profiles) each process scores its own positions and the softmax is
    combined across them, flash-decoding style: the max, then the sum and
    the weighted values, reduced over the sequence's mesh dimensions."""
    import torch.distributed as dist
    mesh = ctx.mesh
    positions = pos[:, None]
    q, k, v = _qkv(p, x, x, cfg, positions, positions, rope=True, ctx=ctx)
    cpl = list(cache_k.placements)
    lpl = cache_layer_placements(cpl)
    seq_dims = shard_dims(lpl, 1)
    kpl = [Replicate() if m in seq_dims else pl for m, pl in enumerate(lpl)]
    masked = cfg.padded_heads != cfg.n_heads
    hd = q.shape[-1]

    def body(ck_all, cv_all, kl, vl, ql, pl_, msk):
        ck, cv = ck_all[slot], cv_all[slot]
        Bl, T = ck.shape[:2]
        off = local_offset(mesh, lpl, 1, T)
        rows = torch.arange(Bl, device=ck.device)
        t = pl_ - off
        ok = ((t >= 0) & (t < T))[:, None, None]
        tc = t.clamp(0, T - 1)
        ck[rows, tc] = torch.where(ok, kl[:, 0].to(ck.dtype), ck[rows, tc])
        cv[rows, tc] = torch.where(ok, vl[:, 0].to(cv.dtype), cv[rows, tc])
        G = ql.shape[2] // ck.shape[2]
        head_to_kv = torch.arange(ql.shape[2], device=ck.device) // G
        kk = ck.index_select(2, head_to_kv)
        vv = cv.index_select(2, head_to_kv)
        s = torch.einsum("bhd,bthd->bht", ql[:, 0], kk).float() / np.sqrt(hd)
        valid = (off + torch.arange(T, device=ck.device))[None, :] \
            <= pl_[:, None]
        s = torch.where(valid[:, None, :], s, -torch.inf)
        if not seq_dims:
            o = torch.einsum("bht,bthd->bhd", torch.softmax(s, dim=-1),
                             vv.float())
        else:
            m = s.amax(dim=-1)
            for md in seq_dims:
                dist.all_reduce(m, dist.ReduceOp.MAX, group=mesh.get_group(md))
            e = torch.exp(s - m[..., None])
            # the weighted values and their sum, reduced in one collective
            acc = torch.cat([torch.einsum("bht,bthd->bhd", e, vv.float()),
                             e.sum(dim=-1)[..., None]], dim=-1)
            for md in seq_dims:
                dist.all_reduce(acc, group=mesh.get_group(md))
            o = acc[..., :-1] / acc[..., -1:]
        o = o[:, None].to(x.dtype)
        if msk is not None:
            o = o * msk[None, None, :, None].to(o.dtype)
        return o

    o = run_local(body, mesh, kpl,
                  [(cache_k, cpl), (cache_v, cpl), (k, kpl), (v, kpl),
                   (q, kpl), (pos, _on_dims(kpl, {0: 0})),
                   (p.head_mask if masked else None,
                    _on_dims(kpl, {2: 0}) if masked else None)], [kpl])
    # split the heads again where wo's are (a local slice): the output
    # projection then reads its own rows of wo instead of gathering them
    return _out_proj(ctx.constrain(o, ("batch", None, "q_heads", None)),
                     p.wo)


# -- MLP -----------------------------------------------------------------------

class MLP(nn.Module):
    AXES = {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
            "w_down": ("mlp", "embed")}

    def __init__(self, cfg, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.w_gate = _param((d, f), cfg, device)
        self.w_up = _param((d, f), cfg, device)
        self.w_down = _param((f, d), cfg, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        dense_init(self.w_gate, generator)
        dense_init(self.w_up, generator)
        dense_init(self.w_down, generator)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``'s ops, x · 1/(1 + exp(-x)), each rounding in x's
    dtype as the reference's do (``F.silu`` rounds once, and differs from
    it by a bf16 ulp)."""
    return x * (1 / (1 + torch.exp(-x)))


def mlp_apply(p: MLP, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU; sharded, column-parallel gate/up and a row-parallel down
    projection (``Partial`` over the mlp axis until the caller's
    constraint reduces it)."""
    if is_dtensor(p.w_gate):
        h = silu(col_parallel(x, p.w_gate)) * col_parallel(x, p.w_up)
        return row_parallel(h, p.w_down)
    h = silu(x @ p.w_gate) * (x @ p.w_up)
    return h @ p.w_down


# -- embedding -------------------------------------------------------------------

class Embedding(nn.Module):
    AXES = {"table": ("vocab", "embed")}

    def __init__(self, cfg, device):
        super().__init__()
        self.table = _param((cfg.vocab_padded, cfg.d_model), cfg, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        dense_init(self.table, generator, scale=0.02)


def embed_lookup(p: Embedding, tokens: torch.Tensor,
                 ctx=NULL_CTX, axes=("batch", "seq")) -> torch.Tensor:
    """Rows of the table; with a mesh ``tokens`` is a full tensor placed by
    ``axes`` and the lookup vocab-parallel (:func:`lookup_rows`)."""
    if ctx.on:
        return lookup_rows(p.table, tokens, ctx, axes)
    return p.table[tokens]
