"""Model facade: family dispatch, initialisation, prefill and decode.

The port's copy of the serving half of the JAX package's ``models/model.py``.
:class:`Model` holds its parameters (an ``nn.Module``), so where the
reference passes ``params`` to every call, the port calls the module.  Every
family serves: the decoder-only ones (dense, MoE, SSM, hybrid, and the VLM
with its vision-stub embeddings) through ``transformer``, the
encoder-decoder one (frame embeddings in, whisper-small) through
``encdec``.  Sharding (``ShardCtx``, ``sharded_greedy``) and training
(``loss``, ``input_specs``, ``abstract_params``) wait for their slices of
the port.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.mapreduce import resolve_device

from . import encdec, transformer


class Model(nn.Module):
    """A model on one device: ``decoder`` (a ``transformer.Decoder``) or,
    for the encoder-decoder family, ``encdec`` (an ``encdec.EncDec``) holds
    the reference's parameter tree as modules; :attr:`net` is whichever
    it has.  Parameters are allocated uninitialised; :meth:`init` draws
    them, or ``convert.load_reference_params`` fills them."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.device = resolve_device(device)
        if cfg.is_encoder_decoder:
            self.encdec = encdec.EncDec(cfg, self.device)
        else:
            self.decoder = transformer.Decoder(cfg, self.device)

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

    def init(self, seed: int = 0) -> "Model":
        """Random weights from ``torch.Generator(device).manual_seed(seed)``,
        drawn one tensor at a time on the model's device."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self.net.reset_parameters(gen)
        return self

    def weight_bytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.parameters())

    # -- serving ----------------------------------------------------------------

    @torch.inference_mode()
    def prefill(self, batch: dict, cache_len: int, last_pos=None):
        """Returns (per-row last-prompt-position logits (B, Vp), caches).

        ``batch["tokens"]``: (B, S) on the model's device; with them, for
        the frontend stubs, ``batch["vision_embeds"]`` (B, n_frontend_tokens,
        D), overwriting the first positions (optional, as the reference),
        or ``batch["frame_embeds"]`` (B, enc_seq, D), the encoder's input
        (required).  ``last_pos``: (B,) index of each row's final prompt
        token (ragged right-padded prompts, continuous batching); None →
        S-1 for all rows.
        """
        cfg = self.cfg
        if cfg.is_encoder_decoder:
            if "frame_embeds" not in batch:
                raise KeyError(
                    f"{cfg.name} encodes batch['frame_embeds'] (B, "
                    f"{cfg.enc_seq}, {cfg.d_model}): its audio frontend is "
                    f"a stub, so the caller supplies the frame embeddings")
            enc_out = encdec.encode(self.encdec, batch["frame_embeds"])
            x, caches = encdec.decode_train(self.encdec, batch["tokens"],
                                            enc_out, cache_len)
        else:
            x, caches = transformer.decoder_forward(
                self.decoder, batch["tokens"], cache_len,
                frontend_embeds=batch.get("vision_embeds"))
        B = x.shape[0]
        if last_pos is None:
            x_last = x[:, -1:, :]
        else:
            x_last = x[torch.arange(B, device=x.device), last_pos][:, None, :]
        logits = transformer.decoder_logits(self.net, x_last)[:, 0]
        return logits, caches

    @torch.inference_mode()
    def decode_step(self, caches: dict, token: torch.Tensor,
                    pos: torch.Tensor):
        """token (B, 1), pos (B,); caches are updated in place.  Returns
        (logits (B, Vp), caches)."""
        if self.cfg.is_encoder_decoder:
            return encdec.encdec_decode_step(self.encdec, caches, token, pos)
        return transformer.decoder_decode_step(self.decoder, caches, token,
                                               pos)

    def empty_caches(self, batch: int, cache_len: int) -> dict:
        if self.cfg.is_encoder_decoder:
            return encdec.encdec_empty_caches(self.cfg, batch, cache_len,
                                              device=self.device)
        return transformer.decoder_empty_caches(self.cfg, batch, cache_len,
                                                device=self.device)


def build_model(name_or_cfg, smoke: bool = False, device="cuda",
                seed: int | None = 0) -> Model:
    """The model of a config or arch name on ``device`` (the card unless the
    caller asks for the CPU), initialised from ``seed`` (``None`` leaves the
    parameters for ``load_reference_params``)."""
    if isinstance(name_or_cfg, ModelConfig):
        cfg = name_or_cfg
    else:
        from repro_torch.configs import get_config
        cfg = get_config(name_or_cfg, smoke=smoke)
    model = Model(cfg, device=device)
    return model if seed is None else model.init(seed)
