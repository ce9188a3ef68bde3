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

The training state crosses in both directions: the reference's ``{"params",
"opt": {"m", "v", "step"[, "err"]}}`` tree into a model and its optimizer
state (``load_reference_state``), and the port's back into that tree
(``state_to_reference``), each block leaf as its slices in order, which
``train.checkpoint`` writes stacked.

A sharded model (DTensor parameters and moments) takes the same trees:
each process copies its shard of every leaf from the full host array, so
nothing crosses between processes; ``state_to_reference`` hands the
DTensors on, and the checkpoint gathers them a leaf at a time.
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


def reference_leaves(model) -> dict:
    """Reference path → the names (``model.named_parameters()``'s) of the
    port parameters it fills: one per slice, in slice order, for a stacked
    block leaf; else one."""
    period = pattern_period(model.cfg)
    out = {}
    for name, _ in model.named_parameters():
        path = tuple(name.split("."))[1:]     # below the net's attribute
        if path[0] not in STACKS:
            out[path] = [name]
        elif path[0] == "blocks":         # layer i → sub{i % P}, slice i // P
            i = int(path[1])
            key = ("blocks", f"sub{i % period}") + path[2:]
            out.setdefault(key, []).append(name)
        else:                             # one layer a slice
            out.setdefault((path[0],) + path[2:], []).append(name)
    return out


def leaf_groups(model) -> list:
    """The parameter names of each reference leaf: the groups that share
    one int8 scale in ``optim.compress_grads``."""
    return list(reference_leaves(model).values())


def _targets(model, tensors: dict | None = None) -> dict:
    """Reference path → the tensors it fills: the model's parameters, or
    ``tensors`` (name → tensor, e.g. an optimizer moment), one per slice."""
    tensors = dict(model.named_parameters()) if tensors is None else tensors
    return {path: [tensors[n] for n in names]
            for path, names in reference_leaves(model).items()}


def reference_shapes(model) -> dict:
    """The reference tree's leaves ``model`` takes: path tuple → shape, the
    block leaves stacked over slices."""
    return {path: ((len(ps),) if path[0] in STACKS else ())
            + tuple(ps[0].shape) for path, ps in _targets(model).items()}


def to_torch(arr) -> torch.Tensor:
    """A CPU tensor with ``arr``'s bits (bf16 through its uint16 view); a
    tensor is taken as it is."""
    if isinstance(arr, torch.Tensor):
        return arr
    arr = np.asarray(arr)
    name = arr.dtype.name
    if name not in _VIA:
        raise TypeError(f"cannot carry a {name} array into torch")
    view, dtype = _VIA[name]
    return torch.from_numpy(np.array(arr, order="C").view(view)).view(dtype)


def _fill(model, tree: dict, tensors: dict | None = None) -> None:
    """Copy a reference tree (nested dicts of numpy arrays or CPU tensors)
    into the model's parameters or ``tensors``.  Raises ``KeyError`` on a
    missing or extra key and ``ValueError`` on a wrong shape or dtype;
    nothing is copied unless the whole tree matches."""
    leaves = _flatten(tree)
    targets = _targets(model, tensors)
    missing = sorted("/".join(k) for k in targets.keys() - leaves.keys())
    extra = sorted("/".join(k) for k in leaves.keys() - targets.keys())
    if missing or extra:
        raise KeyError(f"reference tree does not match {model.cfg.name}: "
                       f"missing {missing}, extra {extra}")
    plan = []
    for path, dests in targets.items():
        src = to_torch(leaves[path])
        stacked = path[0] in STACKS
        want = ((len(dests),) if stacked else ()) + tuple(dests[0].shape)
        if tuple(src.shape) != want or src.dtype != dests[0].dtype:
            raise ValueError(f"{'/'.join(path)}: got {tuple(src.shape)} "
                             f"{src.dtype}, want {want} {dests[0].dtype}")
        plan.append((dests, src if stacked else src[None]))
    with torch.no_grad():
        for dests, src in plan:
            for i, d in enumerate(dests):
                _copy_into(d, src[i])


def _copy_into(dest: torch.Tensor, full: torch.Tensor) -> None:
    """``dest`` ← ``full`` (a host tensor): the whole of it, or a DTensor's
    shard."""
    from repro_torch.sharding import is_dtensor, local_slice
    if is_dtensor(dest):
        dest.to_local().copy_(local_slice(full, dest.device_mesh,
                                          dest.placements))
    else:
        dest.copy_(full)


def load_reference_params(model, tree: dict) -> None:
    """Fill ``model`` from the reference's parameter tree (nested dicts of
    numpy arrays).  Raises ``KeyError`` on a missing or extra key and
    ``ValueError`` on a wrong shape or dtype; nothing is copied unless the
    whole tree matches."""
    _fill(model, tree)


def load_reference_state(model, tree: dict, state: dict) -> None:
    """Fill the model and the port's training state (``train.
    init_train_state``'s ``{"params", "opt"}``) from the reference's
    ``{"params", "opt": {"m", "v", "step"[, "err"]}}`` tree, bit for bit.
    The optimizer keys must be the ones ``state["opt"]`` has."""
    opt = state["opt"]
    if set(tree["opt"]) != set(opt):
        raise KeyError(f"optimizer state {sorted(tree['opt'])} does not "
                       f"match {sorted(opt)}")
    _fill(model, tree["params"])
    for key in ("m", "v", "err"):
        if key in opt:
            _fill(model, tree["opt"][key], opt[key])
    step = to_torch(tree["opt"]["step"])
    if step.shape != () or step.dtype != torch.int32:
        raise ValueError(f"opt/step: got {tuple(step.shape)} {step.dtype}")
    opt["step"].copy_(step)


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def state_to_reference(model, state: dict) -> dict:
    """The port's training state as the reference's tree: parameters
    under ``params``, ``m``, ``v`` (``err``) and ``step`` under ``opt``.
    A leaf is a tensor, or for a stacked block leaf the list of its slices
    in order; nothing is copied."""
    def tree(tensors):
        return _nest({path: dests if path[0] in STACKS else dests[0]
                      for path, dests in _targets(model, tensors).items()})

    opt = state["opt"]
    out = {key: tree(opt[key]) for key in ("m", "v", "err") if key in opt}
    out["step"] = opt["step"]
    return {"params": tree(state["params"]), "opt": out}
