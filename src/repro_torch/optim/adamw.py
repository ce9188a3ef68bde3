"""AdamW with global-norm clipping, a cosine schedule and an optional int8
gradient-compression (error-feedback) stage: the port's copy of the JAX
package's ``optim/adamw.py``, for one device.

Parameters, gradients and the optimizer state are dicts keyed by parameter
name (``dict(model.named_parameters())``): ``m``, ``v`` (and ``err`` with
``compress``) float32 tensors beside each parameter, and ``step`` an int32
scalar on the same device.  :func:`apply_updates` works one parameter at a
time and in place, into ``m``, ``v`` and the parameter itself, so it never
holds a float32 copy of the whole tree (64 GB for a 4-billion-parameter
model).

The arithmetic is the reference's, in float32 and in its order: ``step``
cast to float32, ``b1 ** step`` a float32 power, the update ``mhat /
(sqrt(vhat) + eps) + wd * p`` and then ``p - lr * delta`` in float32, cast
back to the parameter's dtype.  Weight decay applies to every parameter.
Nothing here reads a value back to the host.

Gradient compression: ``compress_grads`` quantizes gradients to int8 with
one scale per reference leaf and keeps the quantization residual in an
error-feedback buffer (added back next step).  The reference stacks a
block parameter over layers into one leaf, where the port keeps one
parameter a layer, so ``groups`` names the port parameters that make up
one reference leaf (``convert.leaf_groups``) and they share one scale.

Sharded: parameters, ``m``, ``v`` and ``err`` are DTensors of one placement
(the parameter's); a gradient arrives in whatever placement autograd left
it (often ``Partial``) and is redistributed to its parameter's first.  The
norm and the compression peaks are reduced over the whole mesh, so they
are the unsharded values; the update runs on each process's shards.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.sharding import is_dtensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    compress: bool = False       # int8 gradient compression w/ error feedback


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac·lr, in float32 (``step``
    a tensor, kept on its device, or an int)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def state_axes(param_axes: dict, cfg: AdamWConfig) -> dict:
    """Optimizer-state logical axes (mirror params; step is replicated)."""
    out = {"m": param_axes, "v": param_axes, "step": ()}
    if cfg.compress:
        out["err"] = param_axes
    return out


def _local(t: torch.Tensor) -> torch.Tensor:
    """A tensor's local shard (itself unless a DTensor), a view."""
    return t.to_local() if is_dtensor(t) else t


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A reduced DTensor scalar as a plain tensor (the same everywhere)."""
    return t.full_tensor() if is_dtensor(t) else t


def init_state(params: dict, cfg: AdamWConfig) -> dict:
    """Zeroed float32 ``m``, ``v`` (and ``err``) beside each parameter
    (placed as it is), and ``step`` 0 as an int32 scalar on the
    parameters' device."""
    def f32():
        return {name: torch.zeros_like(p, dtype=torch.float32,
                                       requires_grad=False)
                for name, p in params.items()}

    device = next(iter(params.values())).device
    state = {"m": f32(), "v": f32(),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.compress:
        state["err"] = f32()
    return state


@torch.no_grad()
def compress_grads(grads: dict, err: dict, groups=None):
    """int8 quantize with error feedback: one scale, max |g + err| / 127, a
    group of names (``groups``; each name alone by default).  Returns
    (dequantized float32 grads, err), ``err`` updated in place."""
    deq = {}
    for group in groups if groups is not None else [[n] for n in grads]:
        peak = torch.stack([_whole((grads[n].float() + err[n]).abs().amax())
                            for n in group]).amax()
        scale = torch.clamp_min(peak, 1e-12) / 127.0
        for n in group:
            g32 = _local(grads[n]).float() + _local(err[n])
            q = torch.clamp(torch.round(g32 / scale), -127, 127) * scale
            _local(err[n]).copy_(g32 - q)
            deq[n] = q if not is_dtensor(grads[n]) else _like(q, grads[n])
    return deq, err


def _like(local: torch.Tensor, ref) -> torch.Tensor:
    """``local`` as a DTensor shard placed like ``ref``."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, ref.device_mesh, ref.placements,
                              run_check=False, shape=ref.shape,
                              stride=ref.stride())


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum, in order, of each tensor's float32 sum of squares."""
    total = None
    for x in tensors:
        sq = _whole(torch.sum(torch.square(x.float())))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: dict, cfg: AdamWConfig,
                  groups=None):
    """One AdamW step, in place into ``params``, ``state["m"]``,
    ``state["v"]`` (``state["err"]``) and ``state["step"]``.  A missing
    gradient (a parameter the loss did not reach) counts as zeros.
    ``groups``: the compression scale's groups (``compress_grads``).
    Returns (params, state, metrics) with ``grad_norm`` and ``lr`` as
    device scalars."""
    grads = {n: _placed(grads[n], p) if grads.get(n) is not None
             else torch.zeros_like(p) for n, p in params.items()}
    step = state["step"]
    step += 1
    if cfg.compress:
        grads, _ = compress_grads(grads, state["err"], groups)
    gnorm = global_norm(grads.values())
    scale = torch.clamp(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                        max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    for name, param in params.items():
        m, v = _local(state["m"][name]), _local(state["v"][name])
        p = _local(param)
        g = _local(grads.pop(name)).float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        del g
        p32 = p.float()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
    return params, state, {"grad_norm": gnorm, "lr": lr}


def _placed(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A gradient in its parameter's placements."""
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g
