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
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .layers import (MLP, Attention, Embedding, RMSNorm, _param, _proj,
                     _out_proj, attention_apply, attention_decode,
                     dense_init, embed_lookup, mlp_apply, remat, rmsnorm)
from .transformer import decoder_logits


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


def _enc_block(p: EncBlock, x, cfg, positions):
    h = rmsnorm(p.norm1, x, cfg.norm_eps)
    out, _ = attention_apply(p.attn, h, cfg, positions, causal=False,
                             rope=False)
    x = x + out
    return x + mlp_apply(p.mlp, rmsnorm(p.norm2, x, cfg.norm_eps))


def _block(cfg, fn, *args):
    """A block ``fn(*args)``, rematerialised in backward with ``cfg.remat``
    (the reference checkpoints each block)."""
    return remat(fn, *args) if cfg.remat else fn(*args)


def encode(m: EncDec, frame_embeds: torch.Tensor) -> torch.Tensor:
    """frame_embeds: (B, enc_seq, D) → encoder output (B, enc_seq, D)."""
    cfg = m.cfg
    x = frame_embeds.to(m.enc_pos.dtype) + m.enc_pos[None]
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)
    for p in m.enc_blocks:
        x = _block(cfg, _enc_block, p, x, cfg, positions)
    return rmsnorm(m.enc_final_norm, x, cfg.norm_eps)


def _dec_block(p: DecBlock, x, enc_out, cfg, positions, enc_positions):
    """Returns (x, self-attention (k, v), cross (k, v))."""
    h = rmsnorm(p.norm1, x, cfg.norm_eps)
    out, kv = attention_apply(p.attn, h, cfg, positions, causal=True,
                              rope=False)
    x = x + out
    hx = rmsnorm(p.norm_x, x, cfg.norm_eps)
    out, cross_kv = attention_apply(p.cross, hx, cfg, positions,
                                    causal=False, kv_x=enc_out,
                                    kv_positions=enc_positions, rope=False)
    x = x + out
    x = x + mlp_apply(p.mlp, rmsnorm(p.norm2, x, cfg.norm_eps))
    return x, kv, cross_kv


def _dec_block_train(*args):
    return _dec_block(*args)[0]


def decode_train(m: EncDec, tokens: torch.Tensor, enc_out: torch.Tensor,
                 cache_len: int | None = None):
    """Teacher-forced decoder pass. Returns final hidden (B, S, D) and, with
    ``cache_len``, the caches (self-attention k/v padded with zeros to it);
    without it (training), each block rematerialised with ``cfg.remat``."""
    cfg = m.cfg
    B, S = tokens.shape
    if cache_len is not None and cache_len < S:
        raise ValueError(f"cache_len {cache_len} < prompt length {S}")
    x = embed_lookup(m.embed, tokens) + m.dec_pos[None, :S]
    positions = _positions(B, S, x.device)
    enc_positions = _positions(B, enc_out.shape[1], x.device)
    if cache_len is None:
        for p in m.dec_blocks:
            x = _block(cfg, _dec_block_train, p, x, enc_out, cfg, positions,
                       enc_positions)
        return rmsnorm(m.final_norm, x, cfg.norm_eps)
    caches = encdec_empty_caches(cfg, B, cache_len, dtype=x.dtype,
                                 device=x.device)
    for i, p in enumerate(m.dec_blocks):
        x, (k, v), (ck, cv) = _dec_block(p, x, enc_out, cfg, positions,
                                         enc_positions)
        caches["k"][i, :, :S] = k
        caches["v"][i, :, :S] = v
        caches["cross_k"][i] = ck
        caches["cross_v"][i] = cv
    return rmsnorm(m.final_norm, x, cfg.norm_eps), caches


def _cross_decode(p: DecBlock, hx: torch.Tensor, xk: torch.Tensor,
                  xv: torch.Tensor) -> torch.Tensor:
    """Cross attention of one token over the fixed encoder K/V (no update,
    no mask, no RoPE), as the reference's decode step computes it inline.
    hx: (B, 1, D); xk, xv: (B, enc_seq, H, hd) → (B, 1, D)."""
    q = _proj(hx, p.cross.wq)[:, 0]                          # (B, H, hd)
    s = torch.einsum("bhd,bthd->bht", q, xk).float()
    s = s / float(np.sqrt(np.float32(q.shape[-1])))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bht,bthd->bhd", w, xv.float()).to(hx.dtype)
    return _out_proj(o, p.cross.wo)[:, None, :]


def encdec_decode_step(m: EncDec, caches: dict, token: torch.Tensor,
                       pos: torch.Tensor):
    """token: (B,1); pos: (B,).  The self-attention caches are updated in
    place.  Returns (logits (B, Vp), caches)."""
    cfg = m.cfg
    x = embed_lookup(m.embed, token) + m.dec_pos[pos][:, None, :]
    for i, p in enumerate(m.dec_blocks):
        h = rmsnorm(p.norm1, x, cfg.norm_eps)
        x = x + attention_decode(p.attn, h, cfg, caches["k"][i],
                                 caches["v"][i], pos)
        hx = rmsnorm(p.norm_x, x, cfg.norm_eps)
        x = x + _cross_decode(p, hx, caches["cross_k"][i],
                              caches["cross_v"][i])
        x = x + mlp_apply(p.mlp, rmsnorm(p.norm2, x, cfg.norm_eps))
    x = rmsnorm(m.final_norm, x, cfg.norm_eps)
    return decoder_logits(m, x)[:, 0, :], caches


def encdec_empty_caches(cfg, batch: int, cache_len: int,
                        dtype=torch.bfloat16, device=None) -> dict:
    """Zeroed caches (module docstring), bf16 by default as the
    reference's."""
    L, H, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((L, batch, cache_len, H, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((L, batch, cache_len, H, hd), dtype=dtype,
                         device=device),
        "cross_k": torch.zeros((L, batch, cfg.enc_seq, H, hd), dtype=dtype,
                               device=device),
        "cross_v": torch.zeros((L, batch, cfg.enc_seq, H, hd), dtype=dtype,
                               device=device),
    }
