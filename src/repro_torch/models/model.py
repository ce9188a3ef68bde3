"""Model facade: family dispatch, initialisation, the training loss,
prefill and decode, and the sharding of all of them.

The port's copy of the JAX package's ``models/model.py``.  :class:`Model`
holds its parameters (an ``nn.Module``), so where the reference passes
``params`` to every call, the port calls the module.  Every family trains
and serves: the decoder-only ones (dense, MoE, SSM, hybrid, and the VLM
with its vision-stub embeddings) through ``transformer``, the
encoder-decoder one (frame embeddings in, whisper-small) through
``encdec``.

Sharding: ``Model(cfg, device, ctx=ShardCtx(mesh, rules))`` builds its
parameters on the ``meta`` device and places each as a DTensor by its
logical axes (:func:`param_axes`), allocating its shard only;
:meth:`Model.init` then draws each parameter whole from the seeded
generator on the device and keeps the shard, so the sharded model has the
unsharded one's numbers and no process ever holds the whole model.  The
model's calls run under that ctx; with a mesh their inputs are full
tensors every process holds alike and their logits DTensors
(:func:`sharded_greedy` picks tokens from them without gathering).
``abstract_params`` (meta tensors), ``param_axes``, ``input_specs``,
``input_axes`` and ``cache_axes`` are the reference's shapes-and-axes
views, which the dry run reads.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.mapreduce import resolve_device
from repro_torch.sharding import NULL_CTX, ShardCtx, is_dtensor

from . import encdec, transformer
from .layers import meta_params

__all__ = ["AUX_LOSS_WEIGHT", "Model", "NULL_CTX", "ShardCtx",
           "build_model", "param_axes", "sharded_greedy"]

AUX_LOSS_WEIGHT = 0.01


class Model(nn.Module):
    """A model on one device: ``decoder`` (a ``transformer.Decoder``) or,
    for the encoder-decoder family, ``encdec`` (an ``encdec.EncDec``) holds
    the reference's parameter tree as modules; :attr:`net` is whichever
    it has.  Parameters are allocated uninitialised; :meth:`init` draws
    them, or ``convert.load_reference_params`` fills them.  With a mesh in
    ``ctx`` each parameter is a DTensor placed by its logical axes."""

    def __init__(self, cfg: ModelConfig, device="cuda", ctx=NULL_CTX):
        super().__init__()
        self.device = resolve_device(device)
        self.ctx = NULL_CTX
        with meta_params() if ctx.on else contextlib.nullcontext():
            if cfg.is_encoder_decoder:
                self.encdec = encdec.EncDec(cfg, self.device)
            else:
                self.decoder = transformer.Decoder(cfg, self.device)
        if ctx.on:      # each process allocates its shards only
            self._replace_params(ctx, lambda p, axes: ctx.zeros(
                p.shape, axes, p.dtype, self.device))

    def _replace_params(self, ctx, make) -> None:
        """Swap every parameter for ``make(parameter, logical axes)`` (a
        DTensor on ``ctx``'s mesh) and take ``ctx`` as the model's."""
        for name, axes in param_axes(self).items():
            mod_name, leaf = name.rsplit(".", 1)
            mod = self.get_submodule(mod_name)
            p = getattr(mod, leaf)
            setattr(mod, leaf, nn.Parameter(make(p, axes),
                                            requires_grad=p.requires_grad))
        self.ctx = ctx

    @property
    def net(self) -> nn.Module:
        net = self._modules.get("encdec")
        return self.decoder if net is None else net

    @property
    def cfg(self) -> ModelConfig:
        """The config the layers read: :attr:`net`'s, the one copy (to
        serve under another config, e.g. a capacity factor, set
        ``net.cfg``)."""
        return self.net.cfg

    def shard(self, mesh, rules: dict | None = None) -> "Model":
        """Place this model's plain parameters on ``mesh`` by ``rules``,
        each process keeping its slice (every process holds the same
        values, e.g. from one seed); a model already on ``mesh`` is left as
        it is."""
        if self.ctx.on:
            if self.ctx.mesh is mesh:
                return self
            raise ValueError("the model is already placed on another mesh; "
                             "build it again on the new one")
        ctx = ShardCtx(mesh, rules)
        self._replace_params(ctx, lambda p, axes: ctx.place(p.detach(), axes))
        return self

    def init(self, seed: int = 0) -> "Model":
        """Random weights from ``torch.Generator(device).manual_seed(seed)``,
        drawn one tensor at a time on the model's device."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self.net.reset_parameters(gen)
        return self

    def weight_bytes(self) -> int:
        """Bytes of parameters this process holds (its shards, sharded)."""
        from repro_torch.sharding import shard_bytes
        return sum(shard_bytes(p) for p in self.parameters())

    def param_specs(self) -> dict:
        """Parameter name → its spec on the model's mesh."""
        from repro_torch.sharding import spec_for
        ctx = self.ctx
        return {name: spec_for(ctx.mesh, axes, ctx.rules,
                               tuple(self.get_parameter(name).shape))
                for name, axes in param_axes(self).items()}

    # -- shapes and axes (the dry run's view) ----------------------------------

    @classmethod
    def abstract_params(cls, cfg: ModelConfig):
        """(name → meta tensor, name → logical axes): the parameters'
        shapes and dtypes with no memory (the reference's ``eval_shape``)."""
        with meta_params():
            model = cls(cfg, device="cpu")
        return dict(model.named_parameters()), param_axes(model)

    def cache_axes(self) -> dict:
        if self.cfg.is_encoder_decoder:
            return encdec.encdec_cache_axes(self.cfg)
        return transformer.cache_axes(self.cfg)

    def input_specs(self, shape) -> dict:
        """Meta-tensor stand-ins for every input of the step function
        (train/prefill: the token batch and frontend stubs; decode: one new
        token, per-request positions and the whole cache)."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len

        def sds(shp, dtype):
            return torch.empty(shp, dtype=dtype, device="meta")

        if shape.kind in ("train", "prefill"):
            out = {"tokens": sds((B, S), torch.int32)}
            if shape.kind == "train":
                out["labels"] = sds((B, S), torch.int32)
            if cfg.frontend == "vision_stub":
                out["vision_embeds"] = sds((B, cfg.n_frontend_tokens,
                                            cfg.d_model), torch.bfloat16)
            if cfg.frontend == "audio_stub":
                out["frame_embeds"] = sds((B, cfg.enc_seq, cfg.d_model),
                                          torch.bfloat16)
            return out
        if shape.kind == "decode":
            if cfg.is_encoder_decoder:
                caches = encdec.encdec_empty_caches(cfg, B, S,
                                                    device="meta")
            else:
                caches = transformer.decoder_empty_caches(cfg, B, S,
                                                          device="meta")
            return {"caches": caches, "token": sds((B, 1), torch.int32),
                    "pos": sds((B,), torch.int32)}
        raise ValueError(shape.kind)

    def input_axes(self, shape) -> dict:
        """Logical axes for :meth:`input_specs` (same keys)."""
        cfg = self.cfg
        if shape.kind in ("train", "prefill"):
            out = {"tokens": ("batch", "seq")}
            if shape.kind == "train":
                out["labels"] = ("batch", "seq")
            if cfg.frontend == "vision_stub":
                out["vision_embeds"] = ("batch", None, None)
            if cfg.frontend == "audio_stub":
                out["frame_embeds"] = ("batch", None, None)
            return out
        return {"caches": self.cache_axes(), "token": ("batch", None),
                "pos": ("batch",)}

    # -- training ---------------------------------------------------------------

    def loss(self, batch: dict, ctx=None):
        """The training loss of a batch on the model's device: ``tokens``
        and ``labels`` (B, S), with ``frame_embeds`` (B, enc_seq, D) for the
        encoder-decoder and, optionally, ``vision_embeds`` for the VLM.
        Returns (loss, {"ce", "aux"}), float32 scalars: cross-entropy plus
        ``AUX_LOSS_WEIGHT`` × the MoE load-balancing loss (0 without MoE
        and for the encoder-decoder).  Gradients reach the parameters that
        require them (``train.init_train_state`` turns them on).  ``ctx``
        defaults to the model's."""
        ctx = self.ctx if ctx is None else ctx
        cfg = self.cfg
        if cfg.is_encoder_decoder:
            enc_out = encdec.encode(self.encdec, batch["frame_embeds"], ctx)
            x = encdec.decode_train(self.encdec, batch["tokens"], enc_out,
                                    ctx=ctx)
            aux = torch.zeros((), dtype=torch.float32,
                              device=batch["tokens"].device)
        else:
            x, aux = transformer.decoder_forward(
                self.decoder, batch["tokens"],
                frontend_embeds=batch.get("vision_embeds"), ctx=ctx)
        ce = transformer.decoder_loss(self.net, x, batch["labels"], ctx=ctx)
        return ce + AUX_LOSS_WEIGHT * aux, {"ce": ce, "aux": aux}

    # -- serving ----------------------------------------------------------------

    @torch.inference_mode()
    def prefill(self, batch: dict, cache_len: int, last_pos=None, ctx=None):
        """Returns (per-row last-prompt-position logits (B, Vp), caches).

        ``batch["tokens"]``: (B, S) on the model's device; with them, for
        the frontend stubs, ``batch["vision_embeds"]`` (B, n_frontend_tokens,
        D), overwriting the first positions (optional, as the reference),
        or ``batch["frame_embeds"]`` (B, enc_seq, D), the encoder's input
        (required).  ``last_pos``: (B,) index of each row's final prompt
        token (ragged right-padded prompts, continuous batching); None →
        S-1 for all rows.  With a mesh the logits are a DTensor (vocab on
        its axis) and the caches DTensors placed by :meth:`cache_axes`.
        """
        ctx = self.ctx if ctx is None else ctx
        cfg = self.cfg
        if cfg.is_encoder_decoder:
            if "frame_embeds" not in batch:
                raise KeyError(
                    f"{cfg.name} encodes batch['frame_embeds'] (B, "
                    f"{cfg.enc_seq}, {cfg.d_model}): its audio frontend is "
                    f"a stub, so the caller supplies the frame embeddings")
            enc_out = encdec.encode(self.encdec, batch["frame_embeds"], ctx)
            x, caches = encdec.decode_train(self.encdec, batch["tokens"],
                                            enc_out, cache_len, ctx=ctx)
        else:
            x, caches = transformer.decoder_forward(
                self.decoder, batch["tokens"], cache_len,
                frontend_embeds=batch.get("vision_embeds"), ctx=ctx)
        x_last = transformer.last_rows(ctx, x, last_pos)
        logits = transformer.decoder_logits(self.net, x_last, ctx)[:, 0]
        return logits, caches

    @torch.inference_mode()
    def decode_step(self, caches: dict, token: torch.Tensor,
                    pos: torch.Tensor, ctx=None):
        """token (B, 1), pos (B,); caches are updated in place.  Returns
        (logits (B, Vp), caches)."""
        ctx = self.ctx if ctx is None else ctx
        if self.cfg.is_encoder_decoder:
            return encdec.encdec_decode_step(self.encdec, caches, token, pos,
                                             ctx)
        return transformer.decoder_decode_step(self.decoder, caches, token,
                                               pos, ctx)

    def empty_caches(self, batch: int, cache_len: int, ctx=None) -> dict:
        ctx = self.ctx if ctx is None else ctx
        if self.cfg.is_encoder_decoder:
            return encdec.encdec_empty_caches(self.cfg, batch, cache_len,
                                              device=self.device, ctx=ctx)
        return transformer.decoder_empty_caches(self.cfg, batch, cache_len,
                                                device=self.device, ctx=ctx)


def param_axes(model: nn.Module) -> dict:
    """Parameter name → its logical axes: the owning module's ``AXES``
    entry (the reference's ``dense_init`` axes, the stacked ``"layers"``
    axis dropped)."""
    out = {}
    for name, _ in model.named_parameters():
        mod_name, leaf = name.rsplit(".", 1)
        out[name] = type(model.get_submodule(mod_name)).AXES[leaf]
    return out


def sharded_greedy(logits, ctx=NULL_CTX) -> torch.Tensor:
    """argmax over vocab-TP logits without all-gathering them: each model
    shard reduces its vocab slice to (max, argmax), and only those pairs
    cross between processes; ties go to the lowest index.  A plain argmax
    without a mesh, for plain logits, or where the vocab does not split
    over the model axis.  Returns (B,) int64, the same on every process."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    if ctx is None or not ctx.on or not is_dtensor(logits):
        return torch.argmax(logits, dim=-1)
    mesh = ctx.mesh
    names = list(mesh.mesh_dim_names)
    V = logits.shape[-1]
    if "model" not in names or V % mesh.size(names.index("model")):
        return torch.argmax(logits.full_tensor(), dim=-1)
    mi = names.index("model")
    pl = [Shard(1) if m == mi else Replicate() for m in range(len(names))]
    local = logits.redistribute(mesh, pl).to_local()      # (B, V/m)
    vloc = local.shape[-1]
    m = local.amax(dim=-1)
    a = local.argmax(dim=-1) + mesh.get_local_rank(mi) * vloc
    group = mesh.get_group(mi)
    gm = m.clone()
    dist.all_reduce(gm, dist.ReduceOp.MAX, group=group)
    cand = torch.where(m >= gm, a, torch.full_like(a, 2 ** 62))
    dist.all_reduce(cand, dist.ReduceOp.MIN, group=group)
    return cand


def build_model(name_or_cfg, smoke: bool = False, device="cuda",
                seed: int | None = 0, mesh=None, rules=None) -> Model:
    """The model of a config or arch name on ``device`` (the card unless the
    caller asks for the CPU), initialised from ``seed`` (``None`` leaves the
    parameters for ``load_reference_params``), its parameters placed on
    ``mesh`` by ``rules`` where a mesh is given."""
    if isinstance(name_or_cfg, ModelConfig):
        cfg = name_or_cfg
    else:
        from repro_torch.configs import get_config
        cfg = get_config(name_or_cfg, smoke=smoke)
    ctx = NULL_CTX if mesh is None else ShardCtx(mesh, rules)
    model = Model(cfg, device=device, ctx=ctx)
    return model if seed is None else model.init(seed)
