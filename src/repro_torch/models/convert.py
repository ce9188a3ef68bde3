"""Carry the JAX package's parameters into a port :class:`Model`.

The reference keeps its parameters as a tree of nested dicts whose block
leaves are stacked over layers under ``blocks/sub0`` (``(n_layers, ...)``,
one super-block period for the dense family).  The port names its modules
after the same keys, so a tree converted to numpy
(``jax.tree.map(np.asarray, params)``) fills the model one-to-one: each
top-level leaf into its parameter, each stacked block leaf one layer a
slice.

bf16 arrays arrive from numpy as ``ml_dtypes.bfloat16`` (dtype name
``"bfloat16"``).  They are carried through their bit patterns
(``arr.view(np.uint16)`` → ``torch.from_numpy`` → ``.view(torch.bfloat16)``),
so the copy is bit-exact and ``ml_dtypes`` is never imported.
"""

from __future__ import annotations

import numpy as np
import torch

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


def _targets(model) -> dict:
    """Reference path → the port parameters it fills (one per layer for a
    stacked block leaf, else one)."""
    dec = model.decoder
    out = {}
    for name, p in dec.named_parameters():
        if not name.startswith("blocks."):
            out[tuple(name.split("."))] = [p]
    for name, _ in dec.blocks[0].named_parameters():
        out[("blocks", "sub0") + tuple(name.split("."))] = [
            blk.get_parameter(name) for blk in dec.blocks]
    return out


def reference_shapes(model) -> dict:
    """The reference tree's leaves ``model`` takes: path tuple → shape, the
    block leaves stacked over layers."""
    return {path: ((len(ps),) if path[0] == "blocks" else ())
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
        stacked = path[0] == "blocks"
        want = shapes[path]
        if tuple(src.shape) != want or src.dtype != params[0].dtype:
            raise ValueError(f"{'/'.join(path)}: got {tuple(src.shape)} "
                             f"{src.dtype}, want {want} {params[0].dtype}")
        plan.append((params, src if stacked else src[None]))
    for params, src in plan:
        for i, p in enumerate(params):
            p.copy_(src[i])
