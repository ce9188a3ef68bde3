"""Mamba-2 mixer via SSD (state-space duality, arXiv:2405.21060).

The port's copy of the JAX package's ``models/ssm.py``.  Prefill uses the
chunked SSD algorithm: quadratic attention-like work *within* chunks plus a
linear inter-chunk state recurrence (the reference's ``lax.scan`` becomes a
loop over chunks).  Decode is the O(1)-state recurrence, updating its
caches in place.  The naive step-by-step recurrence (``ssd_reference``) is
kept as the test oracle.

Shapes (per block): d_inner = expand·d_model; P = ssm_head_dim;
H = d_inner / P heads; N = ssm_state.  n_groups = 1 (B/C shared across
heads).

Parity hazards, each held by a test in ``tests/test_torch_ssm.py``:

* the chunk length: ``L = min(chunk, S)`` shrinks until it divides S (a
  257-token prompt at chunk 256 gives L = 1, a 300-token one L = 150);
  the chunking changes float rounding, so the rule is copied exactly;
* ``jax.nn.softplus`` is ``logaddexp(x, 0)``, not ``F.softplus`` with its
  threshold; ``jax.nn.silu`` is ``layers.silu``; ``_causal_conv`` sums
  its K shifted products in order, starting from 0;
* every decay exponent the chunked form keeps is ≤ 0 (A < 0, dt > 0);
  the reference exponentiates the whole (L, L) segment-sum tile and masks
  after, so above the diagonal exp overflows to inf once a chunk's decay
  passes about 88 (chunks of 256 at full width) and its backward turns
  the mask's zero gradient into 0 · inf = NaN.  The port masks the
  exponent to -inf first: the same forward bits, a finite backward;
* the conv states are the last K−1 *pre-conv* projections, in the
  parameter dtype; the state ``(B, H, P, N)`` is float32.  Like the
  reference, prefill runs the SSM over a ragged row's right-padding too,
  so its state after prefill includes its pad tokens.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import _param, dense_init, head_rmsnorm, remat, silu


def ssm_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_head_dim
    H = d_inner // P
    N = cfg.ssm_state
    return d_inner, H, P, N


class SSM(nn.Module):
    """The reference's 13 ``ssm`` leaves: projections ``w_z``, ``w_x``
    (d, d_inner), ``w_B``, ``w_C`` (d, N), ``w_dt`` (d, H); ``dt_bias``,
    ``A_log`` and ``D_skip`` (H,) in float32; the depthwise convolutions
    ``conv_x`` (K, d_inner), ``conv_B``, ``conv_C`` (K, N); ``out_norm``
    (d_inner,) and ``w_out`` (d_inner, d)."""

    def __init__(self, cfg, device):
        super().__init__()
        d = cfg.d_model
        d_inner, H, _, N = ssm_dims(cfg)
        K = cfg.ssm_conv
        f32 = torch.float32
        self.w_z = _param((d, d_inner), cfg, device)
        self.w_x = _param((d, d_inner), cfg, device)
        self.w_B = _param((d, N), cfg, device)
        self.w_C = _param((d, N), cfg, device)
        self.w_dt = _param((d, H), cfg, device)
        self.dt_bias = _param((H,), cfg, device, dtype=f32)
        self.A_log = _param((H,), cfg, device, dtype=f32)
        self.D_skip = _param((H,), cfg, device, dtype=f32)
        self.conv_x = _param((K, d_inner), cfg, device)
        self.conv_B = _param((K, N), cfg, device)
        self.conv_C = _param((K, N), cfg, device)
        self.out_norm = _param((d_inner,), cfg, device)
        self.w_out = _param((d_inner, d), cfg, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's distributions: ``dense_init`` scales; softplus of
        ``dt_bias`` uniform in log space over [1e-3, 1e-1]; ``A_log`` the
        log of U(1, 16); ``D_skip`` and ``out_norm`` ones."""
        K = self.conv_x.shape[0]
        for w in (self.w_z, self.w_x, self.w_B, self.w_C, self.w_dt,
                  self.w_out):
            dense_init(w, generator)
        for w in (self.conv_x, self.conv_B, self.conv_C):
            dense_init(w, generator, scale=1.0 / np.sqrt(K))
        u = torch.empty_like(self.dt_bias).uniform_(
            float(np.log(1e-3)), float(np.log(1e-1)), generator=generator)
        self.dt_bias.copy_(torch.log(torch.expm1(torch.exp(u))))
        self.A_log.copy_(torch.log(torch.empty_like(self.A_log).uniform_(
            1.0, 16.0, generator=generator)))
        self.D_skip.fill_(1)
        self.out_norm.fill_(1)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, with no threshold (an ulp
    from XLA's exp and log1p at most)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. u: (B, S, C); w: (K, C) → (B, S, C), the K
    shifted products summed in order from 0, as the reference's ``sum``."""
    K, S = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, K - 1, 0))
    out = 0
    for k in range(K):
        out = out + pad[:, k:k + S, :] * w[k][None, None, :]
    return out


def _conv_step(u_t: torch.Tensor, conv_state: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """Single-step conv. u_t: (B, C); conv_state: (B, K-1, C), oldest
    first, shifted in place to hold the newest K-1 inputs."""
    window = torch.cat([conv_state, u_t[:, None, :]], dim=1)  # (B, K, C)
    y = (window * w[None]).sum(dim=1)
    conv_state.copy_(window[:, 1:, :])
    return y


def _chunk_len(S: int, chunk: int) -> int:
    L = min(chunk, S)
    while S % L:
        L -= 1
    return L


def ssd_chunked(x, dt, A, Bm, Cm, D_skip, chunk: int, h0=None):
    """Chunked SSD: a loop over chunks carrying the inter-chunk state.

    x: (B,S,H,P) f32; dt: (B,S,H) f32; A: (H,) f32 (negative);
    Bm, Cm: (B,S,N) f32; D_skip: (H,).
    Returns (y (B,S,H,P), h_final (B,H,P,N)).

    Only one chunk's (L, L, H) decay tensor exists at a time, and in
    training each chunk body is rematerialised in backward (``remat``), as
    the reference checkpoints it.  All decay exponents are ≤ 0 (A < 0,
    dt > 0) → overflow-safe.
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    L = _chunk_len(S, chunk)
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))

    def chunk_step(h, xc, dtc, Bc, Cc, A, D_skip):
        a = dtc * A[None, None, :]                       # (B,L,H) ≤ 0
        cum = torch.cumsum(a, dim=1)                     # inclusive
        total = cum[:, -1, :]                            # (B,H)
        # intra-chunk
        scores = torch.einsum("bin,bjn->bij", Cc, Bc)    # (B,L,L)
        seg = cum[:, :, None, :] - cum[:, None, :, :]    # (B,i,j,H)
        # the reference's where(mask, exp(seg), 0), masking before exp:
        # above the diagonal seg > 0 overflows exp at full width, and the
        # backward's 0 · inf is NaN (module docstring)
        decay = torch.exp(torch.where(mask[None, :, :, None], seg,
                                      -torch.inf))
        M = scores[..., None] * decay * dtc[:, None, :, :]   # (B,i,j,H)
        y = torch.einsum("bijh,bjhp->bihp", M, xc)
        # contribution of the carried state
        y = y + torch.einsum("blh,bln,bhpn->blhp", torch.exp(cum), Cc, h)
        y = y + D_skip[None, None, :, None] * xc
        # state update
        w_state = torch.exp(total[:, None, :] - cum) * dtc   # (B,L,H)
        S_c = torch.einsum("blh,blhp,bln->bhpn", w_state, xc, Bc)
        return torch.exp(total)[:, :, None, None] * h + S_c, y

    ys = []
    for c0 in range(0, S, L):
        at = slice(c0, c0 + L)
        h, y = remat(chunk_step, h, x[:, at], dt[:, at], Bm[:, at],
                     Cm[:, at], A, D_skip)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def ssd_reference(x, dt, A, Bm, Cm, D_skip):
    """Naive per-step recurrence (test oracle). Same shapes as ssd_chunked."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        x_t, dt_t, B_t, C_t = x[:, t], dt[:, t], Bm[:, t], Cm[:, t]
        decay = torch.exp(dt_t * A[None, :])[:, :, None, None]
        inject = (dt_t[:, :, None, None] * x_t[..., None]
                  * B_t[:, None, None, :])
        h = decay * h + inject
        ys.append(torch.einsum("bhpn,bn->bhp", h, C_t)
                  + D_skip[None, :, None] * x_t)
    return torch.stack(ys, dim=1)


def _project(p: SSM, x: torch.Tensor):
    """Shared projections for prefill and decode. x: (..., D)."""
    return (x @ p.w_z, x @ p.w_x, x @ p.w_B, x @ p.w_C,
            (x @ p.w_dt).float())


def ssm_apply(p: SSM, x: torch.Tensor, cfg, chunk: int = 256, h0=None,
              return_state: bool = False):
    """Prefill SSD pass. x: (B,S,D) → (B,S,D) [+ (conv states, h_final)].

    The conv states are ``{"x", "B", "C"}``, each (B, K-1, ·): the last
    K-1 pre-conv projections (zeros before the sequence's start)."""
    B, S, D = x.shape
    d_inner, H, P, N = ssm_dims(cfg)
    z, xs, Bm, Cm, dt_raw = _project(p, x)
    xs_c = silu(_causal_conv(xs, p.conv_x))
    Bm_c = silu(_causal_conv(Bm, p.conv_B))
    Cm_c = silu(_causal_conv(Cm, p.conv_C))

    dt = _softplus(dt_raw + p.dt_bias[None, None, :])
    A = -torch.exp(p.A_log)
    xh = xs_c.reshape(B, S, H, P).float()
    y, h_final = ssd_chunked(xh, dt, A, Bm_c.float(), Cm_c.float(),
                             p.D_skip, chunk, h0=h0)
    y = y.reshape(B, S, d_inner).to(x.dtype)
    y = y * silu(z)
    y = head_rmsnorm(p.out_norm, y, cfg.norm_eps)
    out = y @ p.w_out
    if not return_state:
        return out
    K = cfg.ssm_conv
    conv_states = {name: F.pad(u, (0, 0, K - 1, 0))[:, S:S + K - 1, :]
                   for name, u in (("x", xs), ("B", Bm), ("C", Cm))}
    return out, (conv_states, h_final)


def ssm_decode(p: SSM, x: torch.Tensor, cfg, conv_states: dict,
               h: torch.Tensor) -> torch.Tensor:
    """Single-token decode. x: (B,1,D); conv states ``{"x", "B", "C"}``
    (B,K-1,·); h (B,H,P,N) float32.  The states are updated in place.

    Returns out (B,1,D).
    """
    B = x.shape[0]
    d_inner, H, P, N = ssm_dims(cfg)
    z, xs, Bm, Cm, dt_raw = _project(p, x[:, 0, :])
    xs_t = silu(_conv_step(xs, conv_states["x"], p.conv_x))
    Bm_t = silu(_conv_step(Bm, conv_states["B"], p.conv_B)).float()
    Cm_t = silu(_conv_step(Cm, conv_states["C"], p.conv_C)).float()

    dt = _softplus(dt_raw + p.dt_bias[None, :])             # (B,H)
    A = -torch.exp(p.A_log)
    xh = xs_t.reshape(B, H, P).float()
    decay = torch.exp(dt * A[None, :])[:, :, None, None]
    inject = dt[:, :, None, None] * xh[..., None] * Bm_t[:, None, None, :]
    h.copy_(decay * h + inject)
    y = (torch.einsum("bhpn,bn->bhp", h, Cm_t)
         + p.D_skip[None, :, None] * xh)
    y = y.reshape(B, 1, d_inner).to(x.dtype)
    y = y * silu(z)[:, None, :]
    y = head_rmsnorm(p.out_norm, y, cfg.norm_eps)
    return y @ p.w_out
