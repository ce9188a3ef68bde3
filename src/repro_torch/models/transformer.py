"""Decoder-only transformer supporting dense / MoE / SSM / hybrid layer
stacks: the port's copy of the JAX package's ``models/transformer.py``.

The reference folds the layer pattern (which mixer, which FFN a layer) into
its smallest repeating *period* P, stacks the layers into P parallel stacks
of ``n_layers / P`` super-blocks (``blocks/sub{j}``) and runs one
``lax.scan`` over super-blocks.  Here every layer is its own :class:`Block`
in an ``nn.ModuleList`` and the scan becomes a loop; layer ``i`` holds the
reference's ``blocks/sub{i % P}`` slice ``i // P`` (``convert.py``).

Decode caches are stacked by kind, over the layers of that kind only, in
layer order: ``k``/``v`` ``(n_attn_layers, B, cache_len, Hkv, hd)`` for the
attention layers (the whole stack of a dense model), and for the SSM layers
the conv states ``conv_x`` ``(n_ssm_layers, B, K-1, d_inner)``,
``conv_B``/``conv_C`` ``(n_ssm_layers, B, K-1, N)`` and the float32 state
``(n_ssm_layers, B, H, P, N)``.  ``Decoder.slot[i]`` is layer i's index in
its kind's stack, so a hybrid allocates no KV cache for its SSM layers.  A
decode step writes every cache and state in place and never syncs with
the host.

Training (``decoder_forward`` without ``cache_len``) builds no cache and
keeps every MoE layer's load-balancing loss; with ``cfg.remat`` each block
is rematerialised in backward (the reference checkpoints a super-block of
P layers, which changes memory, not numbers).  ``decoder_loss`` is the
reference's chunked cross-entropy.

Every function takes a ``ctx`` (``sharding.ShardCtx``, ``NULL_CTX`` by
default) and places the reference's constraints: the residual stream on
("batch", "act_seq", None) around each block, the loss's logits on
("batch", None, "vocab").  With a mesh the caches are DTensors placed by
:func:`cache_axes` and each process writes its shard; the loss is the
vocab-parallel cross-entropy (each process picks the gold logit of the
labels in its vocab slice) and returns plain float32 scalars.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.utils.checkpoint import create_selective_checkpoint_contexts

from repro_torch.sharding import NULL_CTX, local_offset, run_local, shard_dims

from .layers import (MLP, Attention, Embedding, RMSNorm, _divisor_chunk,
                     _on_dims, _param, attention_apply, attention_decode,
                     dense_init, embed_lookup, lookup_rows, mlp_apply, remat,
                     rmsnorm, write_cache)
from .moe import MoE, moe_apply, moe_apply_dense
from .ssm import SSM, ssm_apply, ssm_decode, ssm_dims

# the SSM cache keys and the conv-state names ssm_apply/ssm_decode use
CONV_KEYS = {"conv_x": "x", "conv_B": "B", "conv_C": "C"}


def pattern_period(cfg) -> int:
    """The smallest P dividing n_layers with layer i's (mixer, FFN) kinds
    equal to layer i % P's."""
    kinds = [(cfg.layer_kind(i), cfg.ffn_kind(i)) for i in range(cfg.n_layers)]
    for p in range(1, cfg.n_layers + 1):
        if cfg.n_layers % p:
            continue
        if all(kinds[i] == kinds[i % p] for i in range(cfg.n_layers)):
            return p
    return cfg.n_layers


class Block(nn.Module):
    """One decoder layer: ``norm1`` and its mixer (``attn`` or ``ssm``, by
    ``cfg.layer_kind``), then, unless ``cfg.ffn_kind`` is none, ``norm2``
    and its FFN (``mlp`` or ``moe``) — the reference's block keys."""

    def __init__(self, cfg, idx: int, device):
        super().__init__()
        self.norm1 = RMSNorm(cfg, device)
        if cfg.layer_kind(idx) == "attn":
            self.attn = Attention(cfg, device)
        else:
            self.ssm = SSM(cfg, device)
        ffn = cfg.ffn_kind(idx)
        if ffn != "none":
            self.norm2 = RMSNorm(cfg, device)
            if ffn == "moe":
                self.moe = MoE(cfg, device)
            else:
                self.mlp = MLP(cfg, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for mod in self.children():
            mod.reset_parameters(generator)


RESID = ("batch", "act_seq", None)


def _ffn(p: Block, x, cfg, decode: bool, ctx=NULL_CTX):
    """The FFN half of a block.  Returns (x, aux): a routed MoE layer's
    load-balancing loss, else None."""
    if not hasattr(p, "norm2"):
        return x, None
    h = rmsnorm(p.norm2, x, cfg.norm_eps)
    if hasattr(p, "mlp"):
        return ctx.constrain(x + mlp_apply(p.mlp, h), RESID), None
    if decode:
        return x + moe_apply_dense(p.moe, h, cfg, ctx), None
    out, aux = moe_apply(p.moe, h, cfg, ctx)
    return ctx.constrain(x + out, RESID), aux


def block_apply(p: Block, x, cfg, positions, ctx=NULL_CTX):
    """Full-sequence block (train / prefill). Returns (x, cache, aux): the
    cache ``(k, v)`` for an attention layer, ``(conv states, state)`` for
    an SSM layer; aux as :func:`_ffn`'s."""
    h = ctx.constrain(rmsnorm(p.norm1, x, cfg.norm_eps), RESID)
    if hasattr(p, "attn"):
        out, cache = attention_apply(p.attn, h, cfg, positions, ctx=ctx)
    else:
        out, cache = ssm_apply(p.ssm, h, cfg, return_state=True, ctx=ctx)
    x, aux = _ffn(p, ctx.constrain(x + out, RESID), cfg, decode=False,
                  ctx=ctx)
    return x, cache, aux


def block_decode(p: Block, x, cfg, caches: dict, slot: int, pos,
                 ctx=NULL_CTX):
    """Single-token block; updates this layer's caches in place."""
    h = rmsnorm(p.norm1, x, cfg.norm_eps)
    if hasattr(p, "attn"):
        if ctx.on:
            out = attention_decode(p.attn, h, cfg, caches["k"], caches["v"],
                                   pos, ctx=ctx, slot=slot)
        else:
            out = attention_decode(p.attn, h, cfg, caches["k"][slot],
                                   caches["v"][slot], pos)
    elif ctx.on:
        out = ssm_decode(p.ssm, h, cfg, caches, None, ctx=ctx, slot=slot)
    else:
        conv = {name: caches[key][slot] for key, name in CONV_KEYS.items()}
        out = ssm_decode(p.ssm, h, cfg, conv, caches["state"][slot])
    return _ffn(p, x + out, cfg, decode=True, ctx=ctx)[0]


class Decoder(nn.Module):
    """``embed``, ``pos_embed`` (learned positions, ``use_rope=False``
    only), ``out_head`` (untied only), ``final_norm`` and ``blocks``: the
    reference's top-level parameter keys."""
    AXES = {"pos_embed": (None, "embed"), "out_head": ("embed", "vocab")}

    def __init__(self, cfg, device):
        super().__init__()
        self.cfg = cfg
        self.embed = Embedding(cfg, device)
        if not cfg.use_rope:
            self.pos_embed = _param((cfg.max_seq_len, cfg.d_model), cfg,
                                    device)
        if not cfg.tie_embeddings:
            self.out_head = _param((cfg.d_model, cfg.vocab_padded), cfg,
                                   device)
        self.final_norm = RMSNorm(cfg, device)
        self.blocks = nn.ModuleList(Block(cfg, i, device)
                                    for i in range(cfg.n_layers))
        kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
        self.slot = [kinds[:i].count(kind) for i, kind in enumerate(kinds)]

    def reset_parameters(self, generator: torch.Generator) -> None:
        """One tensor at a time, so no stacked float32 temporary exists."""
        self.embed.reset_parameters(generator)
        if hasattr(self, "pos_embed"):
            with torch.no_grad():
                self.pos_embed.zero_()
        if hasattr(self, "out_head"):
            dense_init(self.out_head, generator)
        self.final_norm.reset_parameters(generator)
        for blk in self.blocks:
            blk.reset_parameters(generator)


# -- full-sequence forward ------------------------------------------------------

# remat_policy "dots": the reference's dots_with_no_batch_dims_saveable —
# the products without batch dims (the projections and FFNs, aten.mm) are
# saved, the batched ones (attention scores, P·V, the experts' bmm) and
# everything else recomputed
SAVE_DOTS = functools.partial(create_selective_checkpoint_contexts,
                              [torch.ops.aten.mm.default])


def _train_block(blk: Block, x, cfg, positions, ctx=NULL_CTX):
    x, _, aux = block_apply(blk, x, cfg, positions, ctx)
    return x, aux


def decoder_forward(dec: Decoder, tokens: torch.Tensor,
                    cache_len: int | None = None,
                    frontend_embeds: torch.Tensor | None = None,
                    ctx=NULL_CTX):
    """tokens: (B, S) → final hidden (B, S, D) and, with ``cache_len``
    (prefill), the decode caches, the attention caches zero-padded to
    ``cache_len``; without it (training), the MoE layers' load-balancing
    losses summed in layer order (a float32 scalar, 0 without MoE), no
    cache built and, with ``cfg.remat``, each block rematerialised in
    backward (``remat_policy="dots"``: :data:`SAVE_DOTS`).

    ``frontend_embeds``: (B, n_frontend_tokens, D) stub modality embeddings
    overwriting the leading positions (VLM).  With a mesh, ``tokens`` and
    ``frontend_embeds`` are full tensors every process holds alike."""
    cfg = dec.cfg
    B, S = tokens.shape
    if cache_len is not None and cache_len < S:
        raise ValueError(f"cache_len {cache_len} < prompt length {S}")
    x = embed_lookup(dec.embed, tokens, ctx)
    if frontend_embeds is not None:
        nf = min(frontend_embeds.shape[1], S)
        if ctx.on:
            fe = ctx.place(frontend_embeds[:, :nf].to(x.dtype),
                           ("batch", None, None))
            x = ctx.constrain(x, ("batch", None, None))
            x = torch.cat([fe, x[:, nf:]], dim=1)
        else:
            x[:, :nf] = frontend_embeds[:, :nf].to(x.dtype)
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    if not cfg.use_rope:
        x = x + (lookup_rows(dec.pos_embed, positions, ctx, ("batch", "seq"))
                 if ctx.on else dec.pos_embed[None, :S, :])
    x = ctx.constrain(x, RESID)
    if cache_len is None:
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        context = SAVE_DOTS if cfg.remat_policy == "dots" else None
        for blk in dec.blocks:
            if cfg.remat:
                x, a = remat(_train_block, blk, x, cfg, positions, ctx,
                             context_fn=context)
            else:
                x, a = _train_block(blk, x, cfg, positions, ctx)
            if a is not None:
                aux = aux + a
        return rmsnorm(dec.final_norm, x, cfg.norm_eps), aux
    caches = decoder_empty_caches(cfg, B, cache_len, dtype=x.dtype,
                                  device=tokens.device, ctx=ctx)
    for blk, slot in zip(dec.blocks, dec.slot):
        x, cache, _ = block_apply(blk, x, cfg, positions, ctx)
        if hasattr(blk, "attn"):
            write_cache(ctx, caches["k"], slot, cache[0])
            write_cache(ctx, caches["v"], slot, cache[1])
        elif ctx.on:
            write_ssm_state(ctx, caches, slot, *cache)
        else:
            conv, state = cache
            for key, name in CONV_KEYS.items():
                caches[key][slot] = conv[name]
            caches["state"][slot] = state
    return rmsnorm(dec.final_norm, x, cfg.norm_eps), caches


def write_ssm_state(ctx, caches: dict, slot: int, conv: dict, state) -> None:
    """Write an SSM layer's prefill conv states and state into layer
    ``slot`` of the stacked DTensor caches, each process its shard."""
    from .layers import cache_layer_placements
    for key, new in [(k, conv[n]) for k, n in CONV_KEYS.items()] \
            + [("state", state)]:
        cache = caches[key]
        lpl = cache_layer_placements(cache.placements)

        def body(cl, nl):
            cl[slot] = nl.to(cl.dtype)

        run_local(body, ctx.mesh, lpl, [(cache, list(cache.placements)),
                                        (new, lpl)], [])


def last_rows(ctx, x, last_pos):
    """x (B, S, D) → (B, 1, D): each row's position ``last_pos[b]`` (a full
    tensor), or the last with None."""
    B = x.shape[0]
    if last_pos is None:
        return x[:, -1:, :] if not ctx.on else \
            ctx.constrain(x, ("batch", None, None))[:, -1:, :]
    if not ctx.on:
        return x[torch.arange(B, device=x.device), last_pos][:, None, :]
    x = ctx.constrain(x, ("batch", None, None))
    pl = list(x.placements)

    def body(xl, lp):
        return xl[torch.arange(xl.shape[0], device=xl.device), lp][:, None]

    return run_local(body, ctx.mesh, pl, [(x, pl),
                                          (last_pos, _on_dims(pl, {0: 0}))],
                     [pl])


def decoder_logits(dec: nn.Module, x: torch.Tensor,
                   ctx=NULL_CTX) -> torch.Tensor:
    """Final hidden → (B,S,Vp) f32 logits with pad vocab masked to -1e30.

    The product rounds in the parameter dtype and is cast to float32 after,
    as the reference's ``(x @ head).astype(float32)``.  ``dec`` is a
    :class:`Decoder` or an ``EncDec``: either has ``embed`` and, untied,
    ``out_head``.  With a mesh the product is column-parallel over the
    vocab: the logits come split on ("batch", None, "vocab") and each
    process masks its own slice.
    """
    cfg = dec.cfg
    if ctx.on:
        return _logits_sharded(dec, x, ctx)
    head = dec.embed.table.T if cfg.tie_embeddings else dec.out_head
    logits = (x @ head).float()
    if cfg.vocab_padded > cfg.vocab_size:
        v_idx = torch.arange(cfg.vocab_padded, device=x.device)
        logits = torch.where(v_idx < cfg.vocab_size, logits, -1e30)
    return logits


def _logits_sharded(dec, x, ctx):
    cfg = dec.cfg
    mesh = ctx.mesh
    tied = cfg.tie_embeddings
    w = dec.embed.table if tied else dec.out_head        # (V, D) / (D, V)
    vdim = 0 if tied else 1
    vd = shard_dims(w.placements, vdim)
    wpl = _on_dims(w.placements, {vdim: vdim})
    xpl = [pl if (pl.is_shard() and pl.dim == 0 and m not in vd)
           else Replicate() for m, pl in enumerate(x.placements)]
    out = [xp if xp.is_shard() else (Shard(2) if m in vd else xp)
           for m, xp in enumerate(xpl)]
    pad = cfg.vocab_padded > cfg.vocab_size

    def body(xl, wl):
        lg = (xl @ (wl.T if tied else wl)).float()
        if pad:
            v0 = local_offset(mesh, out, 2, lg.shape[-1])
            v_idx = v0 + torch.arange(lg.shape[-1], device=lg.device)
            lg = torch.where(v_idx < cfg.vocab_size, lg, -1e30)
        return lg

    return run_local(body, mesh, out, [(x, xpl), (w, wpl)], [out])


def _chunk_ce(ctx, logits, labels):
    """Vocab-parallel cross-entropy of a chunk: the sum over its (B, c)
    positions of logsumexp − gold logit, as a DTensor scalar.  Each
    process takes the max over its vocab slice (the global max shifts the
    exponentials, no gradient through it), the sum of exponentials and
    the gold logits of the labels in its slice; the sums are reduced over
    the vocab's mesh dimensions.  logits (B, c, Vp) on ("batch", None,
    "vocab"); labels (B, c) full."""
    import torch.distributed as dist
    mesh = ctx.mesh
    pl = list(logits.placements)
    vd = shard_dims(pl, 2)
    rows = _on_dims(pl, {0: 0})
    part = [Partial() if m in vd else q for m, q in enumerate(rows)]

    def body(lg, lab):
        with torch.no_grad():
            m = lg.amax(dim=-1)
            for d in vd:
                dist.all_reduce(m, dist.ReduceOp.MAX, group=mesh.get_group(d))
        se = torch.exp(lg - m[..., None]).sum(dim=-1)
        v0 = local_offset(mesh, pl, 2, lg.shape[-1])
        idx = lab.long() - v0
        ok = (idx >= 0) & (idx < lg.shape[-1])
        g = torch.gather(lg, -1, idx.clamp(0, lg.shape[-1] - 1)[..., None])
        return se, torch.where(ok, g[..., 0], 0.0), m

    se, gold, m = run_local(body, mesh, pl, [(logits, pl), (labels, rows)],
                            [part, part, rows])
    se = se.redistribute(mesh, rows)
    gold = gold.redistribute(mesh, rows)
    return (m + torch.log(se) - gold).sum()


def decoder_loss(dec: nn.Module, x: torch.Tensor, labels: torch.Tensor,
                 chunk: int = 512, ctx=NULL_CTX) -> torch.Tensor:
    """Chunked cross-entropy over the sequence, the mean over B·S (float32).
    x: (B, S, D); labels: (B, S).  The chunk is the largest size ≤
    ``chunk`` dividing S (the reference's search); each chunk's
    :func:`decoder_logits` (float32, padded vocab masked to -1e30) are
    rematerialised in backward instead of saved, and the chunks' sums add
    in order.  ``dec`` as :func:`decoder_logits`'s.  With a mesh each
    chunk is the vocab-parallel :func:`_chunk_ce`, and the mean a plain
    scalar."""
    B, S, _ = x.shape
    c = _divisor_chunk(S, chunk)
    x = ctx.constrain(x, ("batch", None, None))

    def chunk_loss(xc, lc):
        logits = decoder_logits(dec, xc, ctx)          # (B, c, Vp)
        if ctx.on:
            return _chunk_ce(ctx, logits, lc)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc[..., None].long())[..., 0]
        return (lse - gold).sum()

    total = None
    for c0 in range(0, S, c):
        part = remat(chunk_loss, x[:, c0:c0 + c], labels[:, c0:c0 + c])
        total = part if total is None else total + part
    return ctx.full(total) / (B * S)


def decoder_decode_step(dec: Decoder, caches: dict, token: torch.Tensor,
                        pos: torch.Tensor, ctx=NULL_CTX):
    """token: (B,1); pos: (B,); caches from prefill/empty_caches, updated in
    place.  Returns (logits (B, vocab_padded), caches).  With a mesh token
    and pos are full tensors every process holds alike."""
    cfg = dec.cfg
    x = embed_lookup(dec.embed, token, ctx, ("batch", None))
    if not cfg.use_rope:
        if ctx.on:
            x = x + lookup_rows(dec.pos_embed, pos[:, None], ctx,
                                ("batch", None))
        else:
            x = x + dec.pos_embed[pos][:, None, :]
    x = ctx.constrain(x, ("batch", None, None))
    for blk, slot in zip(dec.blocks, dec.slot):
        x = block_decode(blk, x, cfg, caches, slot, pos, ctx)
    x = rmsnorm(dec.final_norm, x, cfg.norm_eps)
    return decoder_logits(dec, x, ctx)[:, 0, :], caches


CACHE_AXES = {
    "k": ("layers", "cache_batch", "kv_seq", "kv_heads", "head_dim"),
    "v": ("layers", "cache_batch", "kv_seq", "kv_heads", "head_dim"),
    "conv_x": ("layers", "cache_batch", "conv", "mlp"),
    "conv_B": ("layers", "cache_batch", "conv", "ssm_state"),
    "conv_C": ("layers", "cache_batch", "conv", "ssm_state"),
    "state": ("layers", "cache_batch", "ssm_heads", None, "ssm_state"),
}


def cache_axes(cfg) -> dict:
    """Logical axes of :func:`decoder_empty_caches`'s leaves: the
    reference's ``cache_axes`` by kind (the leading axis stacks the layers
    of that kind)."""
    kinds = {cfg.layer_kind(i) for i in range(cfg.n_layers)}
    keys = (["k", "v"] if "attn" in kinds else []) + \
        (["conv_x", "conv_B", "conv_C", "state"] if "ssm" in kinds else [])
    return {key: CACHE_AXES[key] for key in keys}


def decoder_empty_caches(cfg, batch: int, cache_len: int,
                         dtype=torch.bfloat16, device=None,
                         ctx=NULL_CTX) -> dict:
    """Zeroed caches, stacked by kind (module docstring); ``dtype`` (bf16
    by default, as the reference's ``decoder_empty_caches``) for all but
    the float32 SSM state.  A kind with no layers has no keys.  With a
    mesh each is a DTensor placed by :func:`cache_axes`."""
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    n_attn, n_ssm = kinds.count("attn"), kinds.count("ssm")
    caches = {}
    if n_attn:
        shape = (n_attn, batch, cache_len, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        for key in ("k", "v"):
            caches[key] = ctx.zeros(shape, CACHE_AXES[key], dtype, device)
    if n_ssm:
        d_inner, H, P, N = ssm_dims(cfg)
        K = cfg.ssm_conv
        for key, width in (("conv_x", d_inner), ("conv_B", N),
                           ("conv_C", N)):
            caches[key] = ctx.zeros((n_ssm, batch, K - 1, width),
                                    CACHE_AXES[key], dtype, device)
        caches["state"] = ctx.zeros((n_ssm, batch, H, P, N),
                                    CACHE_AXES["state"], torch.float32,
                                    device)
    return caches
