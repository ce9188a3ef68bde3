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
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import (MLP, Attention, Embedding, RMSNorm, _param,
                     attention_apply, attention_decode, dense_init,
                     embed_lookup, mlp_apply, rmsnorm)
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


def _ffn(p: Block, x, cfg, decode: bool):
    if not hasattr(p, "norm2"):
        return x
    h = rmsnorm(p.norm2, x, cfg.norm_eps)
    if hasattr(p, "mlp"):
        return x + mlp_apply(p.mlp, h)
    if decode:
        return x + moe_apply_dense(p.moe, h, cfg)
    return x + moe_apply(p.moe, h, cfg)[0]


def block_apply(p: Block, x, cfg, positions):
    """Full-sequence block (prefill). Returns (x, cache): ``(k, v)`` for an
    attention layer, ``(conv states, state)`` for an SSM layer."""
    h = rmsnorm(p.norm1, x, cfg.norm_eps)
    if hasattr(p, "attn"):
        out, cache = attention_apply(p.attn, h, cfg, positions)
    else:
        out, cache = ssm_apply(p.ssm, h, cfg, return_state=True)
    return _ffn(p, x + out, cfg, decode=False), cache


def block_decode(p: Block, x, cfg, caches: dict, slot: int, pos):
    """Single-token block; updates this layer's caches in place."""
    h = rmsnorm(p.norm1, x, cfg.norm_eps)
    if hasattr(p, "attn"):
        out = attention_decode(p.attn, h, cfg, caches["k"][slot],
                               caches["v"][slot], pos)
    else:
        conv = {name: caches[key][slot] for key, name in CONV_KEYS.items()}
        out = ssm_decode(p.ssm, h, cfg, conv, caches["state"][slot])
    return _ffn(p, x + out, cfg, decode=True)


class Decoder(nn.Module):
    """``embed``, ``pos_embed`` (learned positions, ``use_rope=False``
    only), ``out_head`` (untied only), ``final_norm`` and ``blocks``: the
    reference's top-level parameter keys."""

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

def decoder_forward(dec: Decoder, tokens: torch.Tensor, cache_len: int,
                    frontend_embeds: torch.Tensor | None = None):
    """Prefill. tokens: (B, S) → (final hidden (B, S, D), decode caches);
    the attention caches are zero-padded to ``cache_len``, and a MoE
    layer's load-balancing loss is not kept (training's).

    ``frontend_embeds``: (B, n_frontend_tokens, D) stub modality embeddings
    overwriting the leading positions (VLM)."""
    cfg = dec.cfg
    B, S = tokens.shape
    if cache_len < S:
        raise ValueError(f"cache_len {cache_len} < prompt length {S}")
    x = embed_lookup(dec.embed, tokens)
    if frontend_embeds is not None:
        nf = min(frontend_embeds.shape[1], S)
        x[:, :nf] = frontend_embeds[:, :nf].to(x.dtype)
    if not cfg.use_rope:
        x = x + dec.pos_embed[None, :S, :]
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    caches = decoder_empty_caches(cfg, B, cache_len, dtype=x.dtype,
                                  device=x.device)
    for blk, slot in zip(dec.blocks, dec.slot):
        x, cache = block_apply(blk, x, cfg, positions)
        if hasattr(blk, "attn"):
            caches["k"][slot, :, :S] = cache[0]
            caches["v"][slot, :, :S] = cache[1]
        else:
            conv, state = cache
            for key, name in CONV_KEYS.items():
                caches[key][slot] = conv[name]
            caches["state"][slot] = state
    return rmsnorm(dec.final_norm, x, cfg.norm_eps), caches


def decoder_logits(dec: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Final hidden → (B,S,Vp) f32 logits with pad vocab masked to -1e30.

    The product rounds in the parameter dtype and is cast to float32 after,
    as the reference's ``(x @ head).astype(float32)``.  ``dec`` is a
    :class:`Decoder` or an ``EncDec``: either has ``embed`` and, untied,
    ``out_head``.
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
    if not cfg.use_rope:
        x = x + dec.pos_embed[pos][:, None, :]
    for blk, slot in zip(dec.blocks, dec.slot):
        x = block_decode(blk, x, cfg, caches, slot, pos)
    x = rmsnorm(dec.final_norm, x, cfg.norm_eps)
    return decoder_logits(dec, x)[:, 0, :], caches


def decoder_empty_caches(cfg, batch: int, cache_len: int,
                         dtype=torch.bfloat16, device=None) -> dict:
    """Zeroed caches, stacked by kind (module docstring); ``dtype`` (bf16
    by default, as the reference's ``decoder_empty_caches``) for all but
    the float32 SSM state.  A kind with no layers has no keys."""
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    n_attn, n_ssm = kinds.count("attn"), kinds.count("ssm")
    caches = {}
    if n_attn:
        shape = (n_attn, batch, cache_len, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        caches["k"] = torch.zeros(shape, dtype=dtype, device=device)
        caches["v"] = torch.zeros(shape, dtype=dtype, device=device)
    if n_ssm:
        d_inner, H, P, N = ssm_dims(cfg)
        K = cfg.ssm_conv
        for key, width in (("conv_x", d_inner), ("conv_B", N),
                           ("conv_C", N)):
            caches[key] = torch.zeros((n_ssm, batch, K - 1, width),
                                      dtype=dtype, device=device)
        caches["state"] = torch.zeros((n_ssm, batch, H, P, N),
                                      dtype=torch.float32, device=device)
    return caches
