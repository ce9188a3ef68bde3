"""Count the torch operations one LM decode step issues, a layer pattern
at a time.

    PYTHONPATH=src python -m repro_torch.probes.decode_ops

Eager decode issues its step one ATen operation at a time from the host,
so on the card a step's host time grows with this count, not with the
weights.  The count depends on neither widths nor device, so it is taken
on the CPU: each arch runs at its smoke widths with its full config's
layer pattern and depth (``n_layers``, the attention and MoE periods, the
GQA group padding; an encoder-decoder's encoder depth), B = 8, one decode
step after an 8-token prefill, every ATen call counted by a
``TorchDispatchMode`` (views and in-place writes included).  One line an
arch, then the counts as JSON.  It is the metric of fusing a decode step
(ROADMAP, "Speed of the ported paths", item 8).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import build_model

# full-config fields that shape the layer pattern and its op count
PATTERN = ("n_layers", "n_encoder_layers", "attn_every", "attn_offset",
           "moe_every", "moe_offset", "q_head_pad_group")


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def decode_ops(arch: str) -> int:
    """ATen operations in one decode step of ``arch``'s layer pattern."""
    full = get_config(arch)
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              **{f: getattr(full, f) for f in PATTERN})
    model = build_model(cfg, device="cpu", seed=0)
    toks = torch.ones((8, 8), dtype=torch.long)
    pre = {"tokens": toks}
    if cfg.frontend == "audio_stub":
        pre["frame_embeds"] = torch.zeros((8, cfg.enc_seq, cfg.d_model))
    _, caches = model.prefill(pre, 16)
    pos = torch.full((8,), 8, dtype=torch.long)
    with _Count() as count:
        model.decode_step(caches, toks[:, :1], pos)
    return count.n


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(
        argv)
    counts = {}
    for arch in sorted(ARCH_IDS):
        counts[arch] = decode_ops(arch)
        layers = get_config(arch).n_layers
        print(f"{arch}: {counts[arch]} aten ops a decode step, "
              f"{counts[arch] / layers:.1f} a layer ({layers} layers)")
    print(json.dumps(counts))


if __name__ == "__main__":
    main()
