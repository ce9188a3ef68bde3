"""Decoder-only transformer: the dense path of the JAX package's
``models/transformer.py``.

The reference stacks its layers into super-blocks and runs one ``lax.scan``
over them; here every layer is its own :class:`Block` in an
``nn.ModuleList`` and the scan becomes a loop.  Decode caches are two
tensors ``k``/``v`` of shape ``(n_layers, B, cache_len, Hkv, hd)``, the
reference's ``blocks/sub0`` cache stacked the same way; a decode step
writes each layer's slice in place.

Only dense attention layers with a dense FFN are ported in this slice: a
config whose layers need the SSM mixer or a MoE FFN raises
``NotImplementedError`` naming the slice of the port that brings it.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import (MLP, Attention, Embedding, RMSNorm, _param,
                     attention_apply, attention_decode, dense_init,
                     embed_lookup, mlp_apply, rmsnorm)

# what each unported layer waits for (ROADMAP.md, Queue 1 item 4)
NOT_PORTED = {
    "moe": "MoE FFN layers arrive with the MoE serving slice "
           "(models/moe.py: granite-moe-3b-a800m, qwen3-moe-30b-a3b)",
    "ssm": "SSM mixer layers arrive with the SSM and hybrid slice "
           "(models/ssm.py: mamba2-370m, jamba-v0.1-52b)",
    "encdec": "encoder-decoder models and the frontend stubs arrive with "
              "their own slice (models/encdec.py: whisper-small, "
              "internvl2-76b)",
}


class Block(nn.Module):
    """One (attention + dense FFN) decoder layer: ``norm1``, ``attn``,
    ``norm2`` and ``mlp`` — the reference's block keys."""

    def __init__(self, cfg, idx: int, device):
        super().__init__()
        for kind in (cfg.layer_kind(idx), cfg.ffn_kind(idx)):
            if kind in NOT_PORTED:
                raise NotImplementedError(f"{cfg.name} layer {idx}: "
                                          f"{NOT_PORTED[kind]}")
        self.norm1 = RMSNorm(cfg, device)
        self.attn = Attention(cfg, device)
        self.norm2 = RMSNorm(cfg, device)
        self.mlp = MLP(cfg, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for mod in self.children():
            mod.reset_parameters(generator)


def block_apply(p: Block, x, cfg, positions):
    """Full-sequence block (prefill). Returns (x, (k, v))."""
    h = rmsnorm(p.norm1, x, cfg.norm_eps)
    out, kv = attention_apply(p.attn, h, cfg, positions)
    x = x + out
    return x + mlp_apply(p.mlp, rmsnorm(p.norm2, x, cfg.norm_eps)), kv


def block_decode(p: Block, x, cfg, cache_k, cache_v, pos):
    """Single-token block; updates this layer's caches in place."""
    h = rmsnorm(p.norm1, x, cfg.norm_eps)
    x = x + attention_decode(p.attn, h, cfg, cache_k, cache_v, pos)
    return x + mlp_apply(p.mlp, rmsnorm(p.norm2, x, cfg.norm_eps))


class Decoder(nn.Module):
    """``embed``, ``out_head`` (untied only), ``final_norm`` and ``blocks``:
    the reference's top-level parameter keys."""

    def __init__(self, cfg, device):
        super().__init__()
        if not cfg.use_rope:   # learned absolute positions: whisper only
            raise NotImplementedError(f"{cfg.name}: {NOT_PORTED['encdec']}")
        self.cfg = cfg
        self.embed = Embedding(cfg, device)
        if not cfg.tie_embeddings:
            self.out_head = _param((cfg.d_model, cfg.vocab_padded), cfg,
                                   device)
        self.final_norm = RMSNorm(cfg, device)
        self.blocks = nn.ModuleList(Block(cfg, i, device)
                                    for i in range(cfg.n_layers))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """One tensor at a time, so no stacked float32 temporary exists."""
        self.embed.reset_parameters(generator)
        if hasattr(self, "out_head"):
            dense_init(self.out_head, generator)
        self.final_norm.reset_parameters(generator)
        for blk in self.blocks:
            blk.reset_parameters(generator)


# -- full-sequence forward ------------------------------------------------------

def decoder_forward(dec: Decoder, tokens: torch.Tensor, cache_len: int):
    """Prefill. tokens: (B, S) → (final hidden (B, S, D), decode caches
    padded with zeros to ``cache_len``)."""
    cfg = dec.cfg
    B, S = tokens.shape
    if cache_len < S:
        raise ValueError(f"cache_len {cache_len} < prompt length {S}")
    x = embed_lookup(dec.embed, tokens)
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    caches = decoder_empty_caches(cfg, B, cache_len, dtype=x.dtype,
                                  device=x.device)
    for i, blk in enumerate(dec.blocks):
        x, (k, v) = block_apply(blk, x, cfg, positions)
        caches["k"][i, :, :S] = k
        caches["v"][i, :, :S] = v
    return rmsnorm(dec.final_norm, x, cfg.norm_eps), caches


def decoder_logits(dec: Decoder, x: torch.Tensor) -> torch.Tensor:
    """Final hidden → (B,S,Vp) f32 logits with pad vocab masked to -1e30.

    The product rounds in the parameter dtype and is cast to float32 after,
    as the reference's ``(x @ head).astype(float32)``.
    """
    cfg = dec.cfg
    head = dec.embed.table.T if cfg.tie_embeddings else dec.out_head
    logits = (x @ head).float()
    if cfg.vocab_padded > cfg.vocab_size:
        v_idx = torch.arange(cfg.vocab_padded, device=x.device)
        logits = torch.where(v_idx < cfg.vocab_size, logits, -1e30)
    return logits


# -- decode ---------------------------------------------------------------------

def decoder_decode_step(dec: Decoder, caches: dict, token: torch.Tensor,
                        pos: torch.Tensor):
    """token: (B,1); pos: (B,); caches from prefill/empty_caches, updated in
    place.  Returns (logits (B, vocab_padded), caches)."""
    cfg = dec.cfg
    x = embed_lookup(dec.embed, token)
    for i, blk in enumerate(dec.blocks):
        x = block_decode(blk, x, cfg, caches["k"][i], caches["v"][i], pos)
    x = rmsnorm(dec.final_norm, x, cfg.norm_eps)
    return decoder_logits(dec, x)[:, 0, :], caches


def decoder_empty_caches(cfg, batch: int, cache_len: int,
                         dtype=torch.bfloat16, device=None) -> dict:
    """Zeroed k/v caches ``(n_layers, batch, cache_len, Hkv, hd)``; bf16 by
    default, as the reference's ``decoder_empty_caches``."""
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
