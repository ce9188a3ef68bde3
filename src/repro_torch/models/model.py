"""Model facade: family dispatch, initialisation, prefill and decode.

The port's copy of the serving half of the JAX package's ``models/model.py``.
:class:`Model` holds its parameters (an ``nn.Module``), so where the
reference passes ``params`` to every call, the port calls the module.  The
decoder-only dense family is ported; the encoder-decoder and frontend-stub
families raise.  Sharding (``ShardCtx``, ``sharded_greedy``) and training
(``loss``, ``input_specs``, ``abstract_params``) wait for their slices of
the port.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.mapreduce import resolve_device

from . import transformer


class Model(nn.Module):
    """A decoder on one device: ``decoder`` holds the reference's parameter
    tree as modules.  Parameters are allocated uninitialised; :meth:`init`
    draws them, or ``convert.load_reference_params`` fills them."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        if cfg.is_encoder_decoder or cfg.frontend != "none":
            raise NotImplementedError(
                f"{cfg.name} ({cfg.family}): {transformer.NOT_PORTED['encdec']}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.decoder = transformer.Decoder(cfg, self.device)

    def init(self, seed: int = 0) -> "Model":
        """Random weights from ``torch.Generator(device).manual_seed(seed)``,
        drawn layer by layer on the model's device."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self.decoder.reset_parameters(gen)
        return self

    def weight_bytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.parameters())

    # -- serving ----------------------------------------------------------------

    @torch.inference_mode()
    def prefill(self, batch: dict, cache_len: int, last_pos=None):
        """Returns (per-row last-prompt-position logits (B, Vp), caches).

        ``batch["tokens"]``: (B, S) on the model's device.  ``last_pos``:
        (B,) index of each row's final prompt token (ragged right-padded
        prompts, continuous batching); None → S-1 for all rows.
        """
        x, caches = transformer.decoder_forward(self.decoder,
                                                batch["tokens"], cache_len)
        B = x.shape[0]
        if last_pos is None:
            x_last = x[:, -1:, :]
        else:
            x_last = x[torch.arange(B, device=x.device), last_pos][:, None, :]
        logits = transformer.decoder_logits(self.decoder, x_last)[:, 0]
        return logits, caches

    @torch.inference_mode()
    def decode_step(self, caches: dict, token: torch.Tensor,
                    pos: torch.Tensor):
        """token (B, 1), pos (B,); caches are updated in place.  Returns
        (logits (B, Vp), caches)."""
        return transformer.decoder_decode_step(self.decoder, caches, token,
                                               pos)

    def empty_caches(self, batch: int, cache_len: int) -> dict:
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
