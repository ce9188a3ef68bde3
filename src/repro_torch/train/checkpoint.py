"""Topology-free checkpointing, in the JAX package's format.

A checkpoint is a directory of raw little-endian leaf buffers plus a JSON
manifest (tree paths, shapes, dtypes, step).  Writes are atomic (tmp dir +
rename) so a crash mid-save never corrupts the latest checkpoint; restarts
resume from the newest complete step directory.

Either package reads the other's checkpoints.  The reference's
``load_checkpoint`` rebuilds its tree by *leaf order* from a template, so
the leaves are written in ``jax.tree_util``'s flatten order: the keys of
every dict sorted (``opt`` before ``params``; ``err``, ``m``, ``step``,
``v``).  A leaf is a tensor or numpy array, or a list of tensors: a block
leaf the reference stacks over layers, written as its slices one after
another, which are the stacked array's bytes (``convert.
state_to_reference``).  bf16 is written and read through its uint16 bits,
so ``ml_dtypes`` is never imported; :func:`load_checkpoint` returns CPU
tensors, by path.

A sharded state (DTensor leaves) is saved in the same layout: every process
of the mesh calls :func:`save_checkpoint`, each leaf is gathered whole one
at a time (never the whole tree), process 0 writes, and the others wait at
a barrier at the end.  Loading needs no mesh: the files are the full
leaves, and ``convert.load_reference_state`` keeps each process's shards.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

# manifest dtype name → (numpy dtype of its bytes, torch dtype)
_DTYPES = {"bfloat16": (np.uint16, torch.bfloat16),
           "float32": (np.float32, torch.float32),
           "int32": (np.int32, torch.int32)}


def _flatten(tree, prefix=()) -> list:
    """(path, leaf) in ``jax.tree_util`` order: dict keys sorted."""
    out = []
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            out.extend(_flatten(val, prefix + (key,)))
        else:
            out.append(("/".join(prefix + (key,)), val))
    return out


def _meta(leaf) -> tuple[list, str]:
    """A leaf's stored shape and dtype name (a list of slices stacked)."""
    if isinstance(leaf, (list, tuple)):
        shape, dtype = _meta(leaf[0])
        return [len(leaf)] + shape, dtype
    if isinstance(leaf, torch.Tensor):
        shape = list(leaf.shape)
        dtype = str(leaf.dtype).removeprefix("torch.")
    else:
        leaf = np.asarray(leaf)
        shape, dtype = list(leaf.shape), leaf.dtype.name
    if dtype not in _DTYPES:
        raise TypeError(f"cannot checkpoint a {dtype} leaf")
    return shape, dtype


def _bytes(piece) -> bytes:
    """A tensor's or array's bytes, C order (bf16 through its bits); a
    DTensor is gathered whole first (every process of its mesh calls
    this)."""
    if isinstance(piece, torch.Tensor):
        if _is_dtensor(piece):
            piece = piece.full_tensor()
        t = piece.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    return np.ascontiguousarray(piece).tobytes()


def _is_dtensor(x) -> bool:
    from repro_torch.sharding import is_dtensor
    return is_dtensor(x)


def _pieces(leaf) -> list:
    return list(leaf) if isinstance(leaf, (list, tuple)) else [leaf]


def save_checkpoint(ckpt_dir: str, step: int, tree, keep: int = 3) -> str:
    """Save a tree of nested dicts. Returns the step directory path.  With
    DTensor leaves every process of their mesh calls this; process 0
    writes."""
    import torch.distributed as dist
    leaves = _flatten(tree)
    sharded = any(_is_dtensor(p) for _, leaf in leaves for p in _pieces(leaf))
    writer = not sharded or dist.get_rank() == 0
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if writer:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for i, (path, leaf) in enumerate(leaves):
        shape, dtype = _meta(leaf)
        fname = f"leaf_{i:05d}.bin"
        data = [_bytes(piece) for piece in _pieces(leaf)]
        if writer:
            with open(os.path.join(tmp, fname), "wb") as f:
                for b in data:
                    f.write(b)
        manifest["leaves"].append({"path": path, "file": fname,
                                   "shape": shape, "dtype": dtype})
    if writer:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        # retention
        steps = sorted(all_steps(ckpt_dir))
        for s in steps[:-keep]:
            shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                          ignore_errors=True)
    if sharded:
        dist.barrier()
    return final


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, name, "manifest.json")):
            out.append(int(name.split("_")[1]))
    return sorted(out)


def load_checkpoint(ckpt_dir: str, step: int | None = None, template=None):
    """Load a checkpoint as nested dicts of CPU tensors, by manifest path.

    ``template`` (optional): a tree as :func:`save_checkpoint` takes; the
    checkpoint's paths, shapes and dtypes must be its leaves', in its
    order, or ``ValueError`` is raised.  Returns (tree, step), or (None,
    None) where the directory holds no checkpoint.
    """
    steps = all_steps(ckpt_dir)
    if not steps:
        return None, None
    step = step if step is not None else steps[-1]
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    entries = manifest["leaves"]
    if template is not None:
        want = [(path, *_meta(leaf)) for path, leaf in _flatten(template)]
        got = [(e["path"], e["shape"], e["dtype"]) for e in entries]
        if got != want:
            raise ValueError(f"checkpoint {d} does not match the template")
    tree: dict = {}
    for entry in entries:
        view, dtype = _DTYPES[entry["dtype"]]
        with open(os.path.join(d, entry["file"]), "rb") as f:
            arr = np.frombuffer(f.read(), dtype=view).reshape(entry["shape"])
        node = tree
        *parents, name = entry["path"].split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[name] = torch.from_numpy(arr.copy()).view(dtype)
    return tree, step
