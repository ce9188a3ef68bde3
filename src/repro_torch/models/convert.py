"""Carry the JAX package's parameters into a port :class:`Model`.

The reference keeps its parameters as a tree of nested dicts whose block
leaves are stacked over layers.  A decoder folds its layer pattern into a
period P (``transformer.pattern_period``) and stacks layer ``i`` as slice
``i // P`` of ``blocks/sub{i % P}``; an encoder-decoder stacks every layer
of ``enc_blocks`` and of ``dec_blocks``, one a slice.  The port names its
modules after the same keys, so a tree converted to numpy
(``jax.tree.map(np.asarray, params)``) fills the model one-to-one: each
top-level leaf (``embed``, ``out_head``, ``final_norm``, the learned
``pos_embed``, ``dec_pos`` and ``enc_pos`` ...) into its parameter, each
stacked block leaf one layer a slice.  The dtype check holds each leaf to
its parameter's dtype, so the float32 leaves (a MoE ``router``, an SSM's
``dt_bias``, ``A_log`` and ``D_skip``) stay float32 in a bf16 model.

bf16 arrays arrive from numpy as ``ml_dtypes.bfloat16`` (dtype name
``"bfloat16"``).  They are carried through their bit patterns
(``arr.view(np.uint16)`` → ``torch.from_numpy`` → ``.view(torch.bfloat16)``),
so the copy is bit-exact and ``ml_dtypes`` is never imported.
"""

from __future__ import annotations

import numpy as np
import torch

from .transformer import pattern_period

# numpy dtype name → the torch dtype it carries into, through this view
_VIA = {"bfloat16": (np.uint16, torch.bfloat16),
        "float32": (np.float32, torch.float32)}


def _flatten(tree, prefix=()) -> dict:
    out = {}
    for key, val in tree.items():
        path = prefix + (key,)
        if isinstance(val, dict):
            out.update(_flatten(val, path))
        else:
            out[path] = val
    return out


STACKS = ("blocks", "enc_blocks", "dec_blocks")


def _targets(model) -> dict:
    """Reference path → the port parameters it fills (one per slice, in
    slice order, for a stacked block leaf; else one)."""
    net = model.net
    period = pattern_period(model.cfg)
    out = {}
    for name, p in net.named_parameters():
        path = tuple(name.split("."))
        if path[0] not in STACKS:
            out[path] = [p]
        elif path[0] == "blocks":         # layer i → sub{i % P}, slice i // P
            i = int(path[1])
            key = ("blocks", f"sub{i % period}") + path[2:]
            out.setdefault(key, []).append(p)
        else:                             # one layer a slice
            out.setdefault((path[0],) + path[2:], []).append(p)
    return out


def reference_shapes(model) -> dict:
    """The reference tree's leaves ``model`` takes: path tuple → shape, the
    block leaves stacked over slices."""
    return {path: ((len(ps),) if path[0] in STACKS else ())
            + tuple(ps[0].shape) for path, ps in _targets(model).items()}


def to_torch(arr) -> torch.Tensor:
    """A CPU tensor with ``arr``'s bits (bf16 through its uint16 view)."""
    arr = np.asarray(arr)
    name = arr.dtype.name
    if name not in _VIA:
        raise TypeError(f"cannot carry a {name} array into torch")
    view, dtype = _VIA[name]
    return torch.from_numpy(np.array(arr, order="C").view(view)).view(dtype)


@torch.no_grad()
def load_reference_params(model, tree: dict) -> None:
    """Fill ``model`` from the reference's parameter tree (nested dicts of
    numpy arrays).  Raises ``KeyError`` on a missing or extra key and
    ``ValueError`` on a wrong shape or dtype; nothing is copied unless the
    whole tree matches."""
    leaves = _flatten(tree)
    targets = _targets(model)
    missing = sorted("/".join(k) for k in targets.keys() - leaves.keys())
    extra = sorted("/".join(k) for k in leaves.keys() - targets.keys())
    if missing or extra:
        raise KeyError(f"reference tree does not match {model.cfg.name}: "
                       f"missing {missing}, extra {extra}")
    shapes = reference_shapes(model)
    plan = []
    for path, params in targets.items():
        src = to_torch(leaves[path])
        stacked = path[0] in STACKS
        want = shapes[path]
        if tuple(src.shape) != want or src.dtype != params[0].dtype:
            raise ValueError(f"{'/'.join(path)}: got {tuple(src.shape)} "
                             f"{src.dtype}, want {want} {params[0].dtype}")
        plan.append((params, src if stacked else src[None]))
    for params, src in plan:
        for i, p in enumerate(params):
            p.copy_(src[i])
