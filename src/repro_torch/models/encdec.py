"""Encoder–decoder backbone (whisper-small): the port's copy of the JAX
package's ``models/encdec.py``.

The audio frontend (log-mel + convs) is a STUB: the encoder consumes
precomputed frame embeddings (B, enc_seq, d_model).  Positions are
learned-absolute (``use_rope=False`` in the config).  Decoder layers:
causal self-attention + cross-attention over the encoder output + MLP.
Cross K/V are computed once at prefill and cached; a decode step computes
its cross attention inline over them, as the reference writes it (scores
in float32, no mask, no RoPE), not through ``attention_decode``.

Caches: ``k``/``v`` ``(n_layers, B, cache_len, Hkv, hd)`` (self
attention, written in place a step) and ``cross_k``/``cross_v``
``(n_layers, B, enc_seq, Hkv, hd)`` (fixed after prefill).

Every function takes a ``ctx`` (``sharding.ShardCtx``) and places the
reference's residual constraints; with a mesh the caches are DTensors
placed by :func:`encdec_cache_axes` and the decode step's cross attention
runs on each process's cache shard.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.sharding import NULL_CTX, run_local

from .layers import (MLP, Attention, Embedding, RMSNorm, _on_dims, _param,
                     _proj, _out_proj, attention_apply, attention_decode,
                     cache_layer_placements, dense_init, embed_lookup,
                     lookup_rows, mlp_apply, remat, rmsnorm, write_cache)
from .transformer import RESID, decoder_logits


class EncBlock(nn.Module):
    """``norm1``, ``attn``, ``norm2``, ``mlp``."""

    def __init__(self, cfg, device):
        super().__init__()
        self.norm1 = RMSNorm(cfg, device)
        self.attn = Attention(cfg, device)
        self.norm2 = RMSNorm(cfg, device)
        self.mlp = MLP(cfg, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for mod in self.children():
            mod.reset_parameters(generator)


class DecBlock(EncBlock):
    """An encoder block's keys plus ``norm_x`` and ``cross`` (cross
    attention, no qk-norm)."""

    def __init__(self, cfg, device):
        super().__init__(cfg, device)
        self.norm_x = RMSNorm(cfg, device)
        self.cross = Attention(cfg, device, cross=True)


class EncDec(nn.Module):
    """``embed``, ``dec_pos`` (max_seq_len, d), ``enc_pos`` (enc_seq, d),
    ``out_head`` (untied only), ``enc_final_norm``, ``final_norm``,
    ``enc_blocks`` and ``dec_blocks``: the reference's top-level keys."""
    AXES = {"dec_pos": (None, "embed"), "enc_pos": (None, "embed"),
            "out_head": ("embed", "vocab")}

    def __init__(self, cfg, device):
        super().__init__()
        self.cfg = cfg
        self.embed = Embedding(cfg, device)
        self.dec_pos = _param((cfg.max_seq_len, cfg.d_model), cfg, device)
        self.enc_pos = _param((cfg.enc_seq, cfg.d_model), cfg, device)
        if not cfg.tie_embeddings:
            self.out_head = _param((cfg.d_model, cfg.vocab_padded), cfg,
                                   device)
        self.enc_final_norm = RMSNorm(cfg, device)
        self.final_norm = RMSNorm(cfg, device)
        self.enc_blocks = nn.ModuleList(EncBlock(cfg, device)
                                        for _ in range(cfg.n_encoder_layers))
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, device)
                                        for _ in range(cfg.n_layers))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """One tensor at a time; the learned positions start at zeros."""
        self.embed.reset_parameters(generator)
        with torch.no_grad():
            self.dec_pos.zero_()
            self.enc_pos.zero_()
        if hasattr(self, "out_head"):
            dense_init(self.out_head, generator)
        self.enc_final_norm.reset_parameters(generator)
        self.final_norm.reset_parameters(generator)
        for blk in (*self.enc_blocks, *self.dec_blocks):
            blk.reset_parameters(generator)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None, :].expand(B, S)


def _enc_block(p: EncBlock, x, cfg, positions, ctx=NULL_CTX):
    h = rmsnorm(p.norm1, x, cfg.norm_eps)
    out, _ = attention_apply(p.attn, h, cfg, positions, causal=False,
                             rope=False, ctx=ctx)
    x = x + out
    x = x + mlp_apply(p.mlp, rmsnorm(p.norm2, x, cfg.norm_eps))
    return ctx.constrain(x, RESID)


def _block(cfg, fn, *args):
    """A block ``fn(*args)``, rematerialised in backward with ``cfg.remat``
    (the reference checkpoints each block)."""
    return remat(fn, *args) if cfg.remat else fn(*args)


def encode(m: EncDec, frame_embeds: torch.Tensor,
           ctx=NULL_CTX) -> torch.Tensor:
    """frame_embeds: (B, enc_seq, D) → encoder output (B, enc_seq, D)."""
    cfg = m.cfg
    B, S, _ = frame_embeds.shape
    positions = _positions(B, S, frame_embeds.device)
    if ctx.on:
        fe = ctx.place(frame_embeds.to(m.enc_pos.dtype), ("batch", None, None))
        x = ctx.constrain(fe + lookup_rows(m.enc_pos, positions, ctx,
                                           ("batch", None)), RESID)
    else:
        x = frame_embeds.to(m.enc_pos.dtype) + m.enc_pos[None]
    for p in m.enc_blocks:
        x = _block(cfg, _enc_block, p, x, cfg, positions, ctx)
    return rmsnorm(m.enc_final_norm, x, cfg.norm_eps)


def _dec_block(p: DecBlock, x, enc_out, cfg, positions, enc_positions,
               ctx=NULL_CTX):
    """Returns (x, self-attention (k, v), cross (k, v))."""
    h = rmsnorm(p.norm1, x, cfg.norm_eps)
    out, kv = attention_apply(p.attn, h, cfg, positions, causal=True,
                              rope=False, ctx=ctx)
    x = x + out
    hx = rmsnorm(p.norm_x, x, cfg.norm_eps)
    out, cross_kv = attention_apply(p.cross, hx, cfg, positions,
                                    causal=False, kv_x=enc_out,
                                    kv_positions=enc_positions, rope=False,
                                    ctx=ctx)
    x = x + out
    x = x + mlp_apply(p.mlp, rmsnorm(p.norm2, x, cfg.norm_eps))
    return ctx.constrain(x, RESID), kv, cross_kv


def _dec_block_train(*args):
    return _dec_block(*args)[0]


def decode_train(m: EncDec, tokens: torch.Tensor, enc_out: torch.Tensor,
                 cache_len: int | None = None, ctx=NULL_CTX):
    """Teacher-forced decoder pass. Returns final hidden (B, S, D) and, with
    ``cache_len``, the caches (self-attention k/v padded with zeros to it);
    without it (training), each block rematerialised with ``cfg.remat``."""
    cfg = m.cfg
    B, S = tokens.shape
    if cache_len is not None and cache_len < S:
        raise ValueError(f"cache_len {cache_len} < prompt length {S}")
    dev = tokens.device
    positions = _positions(B, S, dev)
    if ctx.on:
        x = embed_lookup(m.embed, tokens, ctx) + lookup_rows(
            m.dec_pos, positions, ctx, ("batch", "seq"))
    else:
        x = embed_lookup(m.embed, tokens) + m.dec_pos[None, :S]
    x = ctx.constrain(x, RESID)
    enc_positions = _positions(B, enc_out.shape[1], dev)
    if cache_len is None:
        for p in m.dec_blocks:
            x = _block(cfg, _dec_block_train, p, x, enc_out, cfg, positions,
                       enc_positions, ctx)
        return rmsnorm(m.final_norm, x, cfg.norm_eps)
    caches = encdec_empty_caches(cfg, B, cache_len, dtype=x.dtype,
                                 device=dev, ctx=ctx)
    for i, p in enumerate(m.dec_blocks):
        x, (k, v), (ck, cv) = _dec_block(p, x, enc_out, cfg, positions,
                                         enc_positions, ctx)
        write_cache(ctx, caches["k"], i, k)
        write_cache(ctx, caches["v"], i, v)
        write_cache(ctx, caches["cross_k"], i, ck)
        write_cache(ctx, caches["cross_v"], i, cv)
    return rmsnorm(m.final_norm, x, cfg.norm_eps), caches


def _cross_core(q, xk, xv, dtype):
    """q (B, H, hd) over the encoder K/V (B, enc_seq, H, hd): scores in
    float32, no mask."""
    s = torch.einsum("bhd,bthd->bht", q, xk).float()
    s = s / float(np.sqrt(np.float32(q.shape[-1])))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bht,bthd->bhd", w, xv.float()).to(dtype)


def _cross_decode(p: DecBlock, hx: torch.Tensor, xk: torch.Tensor,
                  xv: torch.Tensor, ctx=NULL_CTX,
                  slot: int | None = None) -> torch.Tensor:
    """Cross attention of one token over the fixed encoder K/V (no update,
    no mask, no RoPE), as the reference's decode step computes it inline.
    hx: (B, 1, D); xk, xv: (B, enc_seq, H, hd) → (B, 1, D).  With a mesh
    xk, xv are the stacked DTensor caches and ``slot`` the layer."""
    q = _proj(hx, p.cross.wq)[:, 0]                          # (B, H, hd)
    if not ctx.on:
        return _out_proj(_cross_core(q, xk, xv, hx.dtype),
                         p.cross.wo)[:, None, :]
    cpl = list(xk.placements)
    lpl = cache_layer_placements(cpl)
    qpl = _on_dims(lpl, {0: 0, 2: 1})
    opl = _on_dims(lpl, {0: 0, 2: 2})               # (B, 1, H, hd)
    o = run_local(lambda ck, cv, ql: _cross_core(ql, ck[slot], cv[slot],
                                                 hx.dtype)[:, None],
                  ctx.mesh, qpl, [(xk, cpl), (xv, cpl), (q, qpl)], [opl])
    return _out_proj(o, p.cross.wo)


def encdec_decode_step(m: EncDec, caches: dict, token: torch.Tensor,
                       pos: torch.Tensor, ctx=NULL_CTX):
    """token: (B,1); pos: (B,).  The self-attention caches are updated in
    place.  Returns (logits (B, Vp), caches)."""
    cfg = m.cfg
    if ctx.on:
        x = embed_lookup(m.embed, token, ctx, ("batch", None)) \
            + lookup_rows(m.dec_pos, pos[:, None], ctx, ("batch", None))
        x = ctx.constrain(x, ("batch", None, None))
    else:
        x = embed_lookup(m.embed, token) + m.dec_pos[pos][:, None, :]
    for i, p in enumerate(m.dec_blocks):
        h = rmsnorm(p.norm1, x, cfg.norm_eps)
        if ctx.on:
            x = x + attention_decode(p.attn, h, cfg, caches["k"],
                                     caches["v"], pos, ctx=ctx, slot=i)
            xk, xv = caches["cross_k"], caches["cross_v"]
        else:
            x = x + attention_decode(p.attn, h, cfg, caches["k"][i],
                                     caches["v"][i], pos)
            xk, xv = caches["cross_k"][i], caches["cross_v"][i]
        hx = rmsnorm(p.norm_x, x, cfg.norm_eps)
        x = x + _cross_decode(p, hx, xk, xv, ctx, slot=i)
        x = x + mlp_apply(p.mlp, rmsnorm(p.norm2, x, cfg.norm_eps))
    x = rmsnorm(m.final_norm, x, cfg.norm_eps)
    return decoder_logits(m, x, ctx)[:, 0, :], caches


def encdec_cache_axes(cfg) -> dict:
    """Logical axes of :func:`encdec_empty_caches`'s leaves (the
    reference's)."""
    kv = ("layers", "cache_batch", "kv_seq", "kv_heads", "head_dim")
    cross = ("layers", "cache_batch", None, "kv_heads", "head_dim")
    return {"k": kv, "v": kv, "cross_k": cross, "cross_v": cross}


def encdec_empty_caches(cfg, batch: int, cache_len: int,
                        dtype=torch.bfloat16, device=None,
                        ctx=NULL_CTX) -> dict:
    """Zeroed caches (module docstring), bf16 by default as the
    reference's; DTensors placed by :func:`encdec_cache_axes` with a
    mesh."""
    L, H, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    axes = encdec_cache_axes(cfg)
    shapes = {"k": (L, batch, cache_len, H, hd),
              "v": (L, batch, cache_len, H, hd),
              "cross_k": (L, batch, cfg.enc_seq, H, hd),
              "cross_v": (L, batch, cfg.enc_seq, H, hd)}
    return {key: ctx.zeros(shape, axes[key], dtype, device)
            for key, shape in shapes.items()}
