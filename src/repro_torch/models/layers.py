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
Where autograd records (training), :func:`remat` rematerialises what the
reference wraps in ``jax.checkpoint``: each attention q-chunk here, each
SSD chunk (``ssm``), each loss chunk and, with ``cfg.remat``, each block
(``transformer``, ``encdec``).  Under ``torch.inference_mode`` (prefill,
decode) it is a plain call.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, noop_context_fn


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


def _param(shape, cfg, device, dtype=None) -> nn.Parameter:
    """An uninitialised parameter in the config's dtype (or ``dtype``)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype or torch_dtype(cfg),
                                    device=device), requires_grad=False)


@torch.no_grad()
def dense_init(param: torch.Tensor, generator: torch.Generator,
               scale: float | None = None) -> None:
    """Normal(0, scale) in float32, cast to the parameter's dtype; default
    scale = 1/sqrt(fan_in) with fan_in the first axis, as the reference."""
    if scale is None:
        scale = 1.0 / np.sqrt(param.shape[0])
    param.copy_(torch.randn(param.shape, generator=generator,
                            dtype=torch.float32,
                            device=param.device).mul_(scale))


# -- norm ---------------------------------------------------------------------

class RMSNorm(nn.Module):
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


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk"), in the parameter dtype."""
    return (x @ w.flatten(1)).unflatten(-1, w.shape[1:])


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd"), in the parameter dtype."""
    return o.flatten(-2) @ wo.flatten(0, 1)


def _qkv(p: Attention, x, kv_x, cfg, positions, kv_positions, rope: bool):
    q = _proj(x, p.wq)
    k = _proj(kv_x, p.wk)
    v = _proj(kv_x, p.wv)
    if hasattr(p, "q_norm"):
        q = head_rmsnorm(p.q_norm, q, cfg.norm_eps)
        k = head_rmsnorm(p.k_norm, k, cfg.norm_eps)
    if rope and cfg.use_rope:
        q = apply_rope(q, positions, p.freqs)
        k = apply_rope(k, kv_positions, p.freqs)
    if cfg.padded_heads != cfg.n_heads:
        q = q * p.head_mask[None, None, :, None].to(q.dtype)
    return q, k, v


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


def attention_apply(p: Attention, x, cfg, positions, causal: bool = True,
                    kv_x=None, kv_positions=None, rope: bool = True):
    """Full-sequence attention (prefill / encoder / cross): keys and values
    from ``kv_x`` at ``kv_positions`` (x and positions unless given).

    Returns (out (B,S,D), (k, v)) — k/v returned for cache construction.
    """
    kv_x = x if kv_x is None else kv_x
    kv_positions = positions if kv_positions is None else kv_positions
    q, k, v = _qkv(p, x, kv_x, cfg, positions, kv_positions, rope=rope)
    o = chunked_attention(q, k, v, cfg.n_kv_heads, causal=causal,
                          q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk)
    if cfg.padded_heads != cfg.n_heads:
        o = o * p.head_mask[None, None, :, None].to(o.dtype)
    return _out_proj(o, p.wo), (k, v)


def attention_decode(p: Attention, x, cfg, cache_k, cache_v, pos):
    """Single-token decode. x: (B, 1, D); cache_{k,v}: (B, Smax, Hkv, hd);
    pos: (B,) — per-request current position (continuous batching).

    Writes ``cache[b, pos[b]]`` in place (the reference donates its caches)
    and takes the softmax over the whole cache under the mask ``t <= pos``.
    Returns out (B, 1, D).
    """
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


# -- MLP -----------------------------------------------------------------------

class MLP(nn.Module):
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
    h = silu(x @ p.w_gate) * (x @ p.w_up)
    return h @ p.w_down


# -- embedding -------------------------------------------------------------------

class Embedding(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        self.table = _param((cfg.vocab_padded, cfg.d_model), cfg, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        dense_init(self.table, generator, scale=0.02)


def embed_lookup(p: Embedding, tokens: torch.Tensor) -> torch.Tensor:
    return p.table[tokens]
