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
from torch.distributed.tensor import Shard

from repro_torch.sharding import NULL_CTX, is_dtensor, run_local

from .layers import (_on_dims, _param, cache_layer_placements, col_parallel,
                     dense_init, draw_into, head_rmsnorm, remat,
                     row_parallel, silu)


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
    AXES = {"w_z": ("embed", "mlp"), "w_x": ("embed", "mlp"),
            "w_B": ("embed", "ssm_state"), "w_C": ("embed", "ssm_state"),
            "w_dt": ("embed", "ssm_heads"), "dt_bias": ("ssm_heads",),
            "A_log": ("ssm_heads",), "D_skip": ("ssm_heads",),
            "conv_x": ("conv", "mlp"), "conv_B": ("conv", "ssm_state"),
            "conv_C": ("conv", "ssm_state"), "out_norm": (None,),
            "w_out": ("mlp", "embed")}

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
        H, dev = self.dt_bias.shape[0], generator.device
        u = torch.empty(H, device=dev).uniform_(
            float(np.log(1e-3)), float(np.log(1e-1)), generator=generator)
        draw_into(self.dt_bias, torch.log(torch.expm1(torch.exp(u))))
        draw_into(self.A_log, torch.log(torch.empty(H, device=dev).uniform_(
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
    """Shared projections for prefill and decode. x: (..., D); sharded,
    column-parallel (``layers.col_parallel``)."""
    if is_dtensor(p.w_z):
        return tuple(col_parallel(x, w) for w in
                     (p.w_z, p.w_x, p.w_B, p.w_C)) + (
            col_parallel(x, p.w_dt).float(),)
    return (x @ p.w_z, x @ p.w_x, x @ p.w_B, x @ p.w_C,
            (x @ p.w_dt).float())


def _out(p: SSM, y: torch.Tensor) -> torch.Tensor:
    return row_parallel(y, p.w_out) if is_dtensor(p.w_out) else y @ p.w_out


def _mix(xs, Bm, Cm, dt_raw, conv_x, conv_B, conv_C, dt_bias, A_log,
         D_skip, H: int, P: int, chunk: int, h0, dtype):
    """The SSM between its projections: convolutions, softplus, SSD.
    Returns (y (B, S, H·P) in ``dtype``, h_final)."""
    B, S, _ = xs.shape
    xs_c = silu(_causal_conv(xs, conv_x))
    Bm_c = silu(_causal_conv(Bm, conv_B))
    Cm_c = silu(_causal_conv(Cm, conv_C))
    dt = _softplus(dt_raw + dt_bias[None, None, :])
    A = -torch.exp(A_log)
    xh = xs_c.reshape(B, S, H, P).float()
    y, h_final = ssd_chunked(xh, dt, A, Bm_c.float(), Cm_c.float(),
                             D_skip, chunk, h0=h0)
    return y.reshape(B, S, H * P).to(dtype), h_final


def ssm_apply(p: SSM, x: torch.Tensor, cfg, chunk: int = 256, h0=None,
              return_state: bool = False, ctx=NULL_CTX):
    """Prefill SSD pass. x: (B,S,D) → (B,S,D) [+ (conv states, h_final)].

    The conv states are ``{"x", "B", "C"}``, each (B, K-1, ·): the last
    K-1 pre-conv projections (zeros before the sequence's start).

    With a mesh the reference's layout: the input and projections on
    ("ssm_batch", None, ·), the sequence never sharded (SSD is sequential
    over chunks), and the convolutions and scan on each process's batch
    and head shards (heads are independent)."""
    B, S, D = x.shape
    d_inner, H, P, N = ssm_dims(cfg)
    x = ctx.constrain(x, ("ssm_batch", None, None))
    z, xs, Bm, Cm, dt_raw = _project(p, x)
    if ctx.on:
        z = ctx.constrain(z, ("ssm_batch", None, "mlp"))
        y, h_final, conv_states = _mix_sharded(p, ctx, xs, Bm, Cm, dt_raw,
                                               H, P, chunk, h0, x.dtype,
                                               cfg.ssm_conv)
    else:
        y, h_final = _mix(xs, Bm, Cm, dt_raw, p.conv_x, p.conv_B, p.conv_C,
                          p.dt_bias, p.A_log, p.D_skip, H, P, chunk, h0,
                          x.dtype)
    y = y * silu(z)
    y = head_rmsnorm(p.out_norm, y, cfg.norm_eps)
    out = _out(p, y)
    if not return_state:
        return out
    if not ctx.on:
        K = cfg.ssm_conv
        conv_states = {name: F.pad(u, (0, 0, K - 1, 0))[:, S:S + K - 1, :]
                       for name, u in (("x", xs), ("B", Bm), ("C", Cm))}
    return out, (conv_states, h_final)


def _mix_sharded(p: SSM, ctx, xs, Bm, Cm, dt_raw, H, P, chunk, h0, dtype, K):
    """:func:`_mix` on each process's shards: the batch on ``ssm_batch``
    and the heads (dt's ``ssm_heads`` placement, with the channels of
    those heads) sharded alike in every input, so each process scans its
    own rows and heads.  Also returns the conv states."""
    S = xs.shape[1]
    hp = ctx.placements(("ssm_batch", None, "ssm_heads"), dt_raw.shape)
    rows = _on_dims(hp, {0: 0})                 # (B, S, N): batch only
    vec = _on_dims(hp, {2: 0})                  # (H,) or (d_inner,)
    conv = _on_dims(hp, {2: 1})                 # (K, d_inner)
    rep = _on_dims(hp, {})
    st = _on_dims(hp, {0: 0, 2: 1})             # (B, H, P, N)

    def body(xs, Bm, Cm, dt_raw, cx, cB, cC, bias, a_log, d_skip):
        Hl = dt_raw.shape[-1]
        y, h = _mix(xs, Bm, Cm, dt_raw, cx, cB, cC, bias, a_log, d_skip,
                    Hl, P, chunk, None, dtype)
        tail = [F.pad(u, (0, 0, K - 1, 0))[:, S:S + K - 1, :]
                for u in (xs, Bm, Cm)]
        return (y, h, *tail)

    if h0 is not None:
        raise NotImplementedError("a carried SSM state under a mesh")
    y, h, cx, cB, cC = run_local(
        body, ctx.mesh, hp,
        [(xs, hp), (Bm, rows), (Cm, rows), (dt_raw, hp), (p.conv_x, conv),
         (p.conv_B, rep), (p.conv_C, rep), (p.dt_bias, vec),
         (p.A_log, vec), (p.D_skip, vec)],
        [hp, st, hp, rows, rows])
    return y, h, {"x": cx, "B": cB, "C": cC}


def _step(xs, Bm, Cm, dt_raw, conv_states, h, conv_x, conv_B, conv_C,
          dt_bias, A_log, D_skip, P: int, dtype):
    """One token's SSM between its projections; the states in place.
    Returns y (B, H·P) in ``dtype``."""
    B, H = dt_raw.shape
    xs_t = silu(_conv_step(xs, conv_states["x"], conv_x))
    Bm_t = silu(_conv_step(Bm, conv_states["B"], conv_B)).float()
    Cm_t = silu(_conv_step(Cm, conv_states["C"], conv_C)).float()

    dt = _softplus(dt_raw + dt_bias[None, :])             # (B,H)
    A = -torch.exp(A_log)
    xh = xs_t.reshape(B, H, P).float()
    decay = torch.exp(dt * A[None, :])[:, :, None, None]
    inject = dt[:, :, None, None] * xh[..., None] * Bm_t[:, None, None, :]
    h.copy_(decay * h + inject)
    y = (torch.einsum("bhpn,bn->bhp", h, Cm_t)
         + D_skip[None, :, None] * xh)
    return y.reshape(B, H * P).to(dtype)


def ssm_decode(p: SSM, x: torch.Tensor, cfg, conv_states: dict,
               h: torch.Tensor, ctx=NULL_CTX,
               slot: int | None = None) -> torch.Tensor:
    """Single-token decode. x: (B,1,D); conv states ``{"x", "B", "C"}``
    (B,K-1,·); h (B,H,P,N) float32.  The states are updated in place.
    With a mesh ``conv_states`` is the whole stacked cache dict (DTensors,
    ``h`` unused) and ``slot`` the layer; each process steps the rows and
    heads of its cache shard.

    Returns out (B,1,D).
    """
    B = x.shape[0]
    d_inner, H, P, N = ssm_dims(cfg)
    z, xs, Bm, Cm, dt_raw = _project(p, x[:, 0, :])
    if ctx.on:
        y = _step_sharded(p, ctx, conv_states, slot, xs, Bm, Cm, dt_raw, P,
                          x.dtype)
    else:
        y = _step(xs, Bm, Cm, dt_raw, conv_states, h, p.conv_x, p.conv_B,
                  p.conv_C, p.dt_bias, p.A_log, p.D_skip, P, x.dtype)
    y = y[:, None, :] * silu(z)[:, None, :]
    y = head_rmsnorm(p.out_norm, y, cfg.norm_eps)
    return _out(p, y)


def _step_sharded(p: SSM, ctx, caches: dict, slot: int, xs, Bm, Cm, dt_raw,
                  P: int, dtype):
    """:func:`_step` on each process's shard of the stacked caches: the
    state's placements (batch on ``cache_batch``, heads on ``ssm_heads``)
    decide the rows and heads every input is cut to."""
    spl = list(caches["state"].placements)
    lst = cache_layer_placements(spl)              # (B, H, P, N)
    hp = _on_dims(lst, {0: 0, 1: 1})               # (B, H) and (B, d_inner)
    rows = _on_dims(lst, {0: 0})
    vec = _on_dims(lst, {1: 0})
    conv = _on_dims(lst, {1: 1})
    rep = _on_dims(lst, {})
    keys = ("conv_x", "conv_B", "conv_C")
    # the reference places each cache leaf alone, so a model axis that
    # divides the channels but not the heads shards conv_x and replicates
    # the state: such a conv cache steps as a copy in the state's layout,
    # and each process writes its own shard of it back
    conv_in, cut = {}, {}
    for key in keys:
        need = _on_dims(lst, {0: 0, 1: 2}) if key == "conv_x" else \
            _on_dims(lst, {0: 0})
        stacked = [Shard(pl.dim + 1) if pl.is_shard() else pl
                   for pl in need]
        conv_in[key] = caches[key]
        if list(caches[key].placements) != stacked:
            conv_in[key] = cut[key] = caches[key].redistribute(ctx.mesh,
                                                               stacked)

    def body(cxa, cBa, cCa, sta, xs, Bm, Cm, dt_raw, cx, cB, cC, bias,
             a_log, d_skip):
        states = {"x": cxa[slot], "B": cBa[slot], "C": cCa[slot]}
        return _step(xs, Bm, Cm, dt_raw, states, sta[slot], cx, cB, cC,
                     bias, a_log, d_skip, P, dtype)

    cpl = [list(conv_in[k].placements) for k in keys]
    y = run_local(
        body, ctx.mesh, hp,
        [(conv_in["conv_x"], cpl[0]), (conv_in["conv_B"], cpl[1]),
         (conv_in["conv_C"], cpl[2]), (caches["state"], spl), (xs, hp),
         (Bm, rows), (Cm, rows), (dt_raw, hp), (p.conv_x, conv),
         (p.conv_B, rep), (p.conv_C, rep), (p.dt_bias, vec),
         (p.A_log, vec), (p.D_skip, vec)], [hp])
    for key, copy in cut.items():
        caches[key].to_local().copy_(
            copy.redistribute(ctx.mesh, caches[key].placements).to_local())
    return y
