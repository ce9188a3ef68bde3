"""Logical-axis sharding on ``torch.distributed``'s ``DeviceMesh`` and DTensor:
the port's copy of the JAX package's ``sharding.py``.

Parameters and activations carry *logical* axis names (``"embed"``,
``"mlp"``, ``"vocab"`` ...) which a rules table maps to mesh axes — the
MaxText/Flax pattern.  The default production profile:

* weights: TP on the ``model`` axis along mlp/head/vocab/expert dims and
  FSDP on the ``data`` axis along the embed (d_model) dim, so a process's
  weight bytes scale with 1/(data·model);
* activations: batch on ``data``; the residual-stream sequence on ``model``
  (Megatron-style sequence parallelism);
* long-context decode: the KV-cache sequence on ``data`` (batch-1 cells).

The multi-pod mesh folds the ``pod`` axis into data parallelism: every rule
that maps to ``"data"`` maps to ``("pod", "data")`` when a pod axis is
present.

A *spec* is the reference's ``PartitionSpec`` as a plain tuple, one entry a
tensor dimension: ``None``, a mesh-axis name, or a tuple of names.  The spec
logic (:func:`spec_for`, :func:`tree_specs`) is pure: it works on any object
with ``axis_names`` and ``shape`` (a name → size mapping), as the
reference's does, or on a ``DeviceMesh`` (its ``mesh_dim_names``).
:func:`placements_for` turns a spec into DTensor placements, one a mesh
dimension: ``Shard(d)`` where tensor dimension ``d`` names that mesh axis,
else ``Replicate()``; a tuple ``("pod", "data")`` on dimension ``d`` is
``Shard(d)`` on both mesh dimensions, major to minor as the mesh orders them.
:func:`constrain` redistributes a DTensor to a spec (the reference's
``with_sharding_constraint``); a plain tensor passes through.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

# -- rule tables -------------------------------------------------------------

# logical axis -> physical mesh axis (or None = replicate)
DEFAULT_RULES = {
    "batch": "data",
    "seq": None,            # sequence of *inputs* (token ids) — replicated dims
    "act_seq": "model",     # residual-stream sequence (sequence parallelism)
    "embed": "data",        # FSDP dim of weights
    "mlp": "model",         # TP dim of weights
    "q_heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "vocab": "model",
    "experts": "model",     # expert parallelism
    "expert_mlp": None,
    "layers": None,         # stacked-layer dim — never sharded
    "kv_seq": None,         # KV cache sequence (decode)
    "cache_batch": "data",
    "conv": None,
    "ssm_state": None,
    "ssm_heads": "model",
    # SSM-block batch: SSD is sequential over seq but embarrassingly parallel
    # over batch — prefer batch sharded over BOTH axes, fall back to data only
    # (a list = candidates, tried in order until divisible + conflict-free)
    "ssm_batch": [("data", "model"), "data"],
}

# long-context decode (global_batch == 1): shard the KV/history over `data`,
# replicate weights over `data` (no per-step FSDP all-gather at batch 1)
LONG_CONTEXT_OVERRIDES = {
    "batch": None,
    "cache_batch": None,
    "kv_seq": ["data", "model"],
    "embed": None,
}

# batched decode: weights replicated over `data` (serving reads every weight
# each step, so FSDP's per-step all-gather only costs link time); the
# KV-cache *sequence* sharded over `model` (the flash-decoding layout) —
# kv-head counts rarely divide the model axis, the sequence always does
DECODE_OVERRIDES = {
    "embed": None,
    "kv_seq": ["model"],
    "kv_heads": None,
}


def make_rules(profile: str = "default") -> dict:
    rules = dict(DEFAULT_RULES)
    if profile == "long_context":
        rules.update(LONG_CONTEXT_OVERRIDES)
    elif profile == "decode":
        rules.update(DECODE_OVERRIDES)
    elif profile != "default":
        raise ValueError(f"unknown sharding profile {profile!r}")
    return rules


# -- the mesh as the spec logic sees it --------------------------------------------

def axis_names(mesh) -> tuple:
    """The mesh's axis names, major to minor."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """Axis name → size, for a ``DeviceMesh`` or an object with a ``shape``
    mapping."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def physical_axis(mesh, phys):
    """Map a rule target onto the mesh, folding `pod` into data parallelism."""
    if phys is None:
        return None
    if phys == "data" and "pod" in axis_names(mesh):
        return ("pod", "data")
    return phys


def _flatten_phys(mesh, phys):
    """Fold pod into data and flatten nested tuples → tuple of mesh axes."""
    if phys is None:
        return None
    if isinstance(phys, str):
        p = physical_axis(mesh, phys)
        return p if isinstance(p, tuple) else (p,)
    out = []
    for el in phys:
        f = _flatten_phys(mesh, el)
        if f:
            out.extend(f)
    return tuple(out)


def spec_for(mesh, logical_axes, rules: dict, shape=None) -> tuple:
    """Logical axes tuple (may contain None) → spec tuple for this mesh.

    * When ``shape`` is given, any dimension not divisible by its mapped mesh
      axis falls back to the next candidate or to replication (e.g. 9 query
      heads cannot TP-shard 16 ways).
    * A rules value may be a LIST of candidates tried in order.
    * A mesh axis already consumed by an earlier dim of the same spec is
      skipped (a spec never repeats an axis).
    """
    sizes = axis_sizes(mesh)
    parts = []
    used: set = set()
    for i, ax in enumerate(logical_axes):
        if ax is None:
            parts.append(None)
            continue
        if ax not in rules:
            raise KeyError(f"logical axis {ax!r} missing from rules")
        rule = rules[ax]
        candidates = rule if isinstance(rule, list) else [rule]
        chosen = None
        for cand in candidates:
            phys = _flatten_phys(mesh, cand)
            if phys is None:
                break
            if any(a in used for a in phys):
                continue
            size = 1
            for a in phys:
                size *= sizes[a]
            if shape is not None and shape[i] % size != 0:
                continue
            chosen = phys
            break
        if chosen is None:
            parts.append(None)
        else:
            used.update(chosen)
            parts.append(chosen[0] if len(chosen) == 1 else chosen)
    return tuple(parts)


def _is_axes(x) -> bool:
    return isinstance(x, tuple)


def _tree_map(fn, tree, *others):
    """``fn`` over the leaves (axes tuples) of nested dicts, with the
    matching leaves of ``others`` (same structure)."""
    if _is_axes(tree):
        return fn(tree, *others)
    return {k: _tree_map(fn, v, *(o[k] for o in others))
            for k, v in tree.items()}


def tree_specs(mesh, axes_tree, rules: dict, shapes_tree=None):
    """Map an axes tree (nested dicts, tuple leaves) to specs; with
    ``shapes_tree`` (leaves with a ``shape``), shape-aware."""
    if shapes_tree is None:
        return _tree_map(lambda axes: spec_for(mesh, axes, rules), axes_tree)
    return _tree_map(lambda axes, s: spec_for(mesh, axes, rules, s.shape),
                     axes_tree, shapes_tree)


# -- DTensor placements --------------------------------------------------------------

def placements_for(mesh, spec) -> list:
    """A spec → one DTensor placement a mesh dimension."""
    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        dims = [names.index(a) for a in group]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {names}")
        for m in dims:
            out[m] = Shard(d)
    return out


def sharding_for(mesh, logical_axes, rules: dict, shape=None) -> list:
    """The placements of a tensor with these logical axes (the reference's
    ``NamedSharding``)."""
    return placements_for(mesh, spec_for(mesh, logical_axes, rules, shape))


def tree_shardings(mesh, axes_tree, rules: dict, shapes_tree=None):
    """Map an axes tree to placements (shape-aware with ``shapes_tree``)."""
    if shapes_tree is None:
        return _tree_map(lambda axes: sharding_for(mesh, axes, rules),
                         axes_tree)
    return _tree_map(lambda axes, s: sharding_for(mesh, axes, rules, s.shape),
                     axes_tree, shapes_tree)


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def constrain(x, mesh, logical_axes, rules: dict):
    """Redistribute a DTensor to the placements of its logical axes
    (shape-aware fallback); a plain tensor is returned as it is."""
    if not is_dtensor(x):
        return x
    want = sharding_for(mesh, logical_axes, rules, tuple(x.shape))
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(mesh, want)


def local_shape(shape, mesh, placements) -> tuple:
    """The shape of this process's shard of a ``shape`` tensor (every
    sharded dimension divides evenly, as :func:`spec_for` ensures)."""
    out = list(shape)
    for m, pl in enumerate(placements):
        if pl.is_shard():
            n = mesh.size(m)
            if out[pl.dim] % n:
                raise ValueError(f"dimension {pl.dim} of {tuple(shape)} does "
                                 f"not split {n} ways")
            out[pl.dim] //= n
    return tuple(out)


def local_slice(full, mesh, placements):
    """This process's shard of the full tensor ``full`` (a view; nothing
    crosses between processes).  Sharded dimensions split in mesh order,
    major to minor."""
    out = full
    for m, pl in enumerate(placements):
        if pl.is_shard():
            n = mesh.size(m)
            size = out.shape[pl.dim] // n
            out = out.narrow(pl.dim, mesh.get_local_rank(m) * size, size)
    return out


def from_full(full, mesh, placements):
    """A DTensor from a full tensor every process holds alike: each keeps
    a copy of its shard (no communication)."""
    # a copy: a view of ``full`` cannot carry a DTensor under inference mode
    local = local_slice(full, mesh, placements).clone(
        memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, placements,
                              run_check=False, shape=tuple(full.shape),
                              stride=_contiguous_stride(full.shape))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def global_shape(local_shape_, mesh, placements) -> tuple:
    out = list(local_shape_)
    for m, pl in enumerate(placements):
        if pl.is_shard():
            out[pl.dim] *= mesh.size(m)
    return tuple(out)


def local_offset(mesh, placements, dim: int, local_size: int) -> int:
    """Where this process's shard starts along tensor dimension ``dim``."""
    idx = 0
    for m, pl in enumerate(placements):
        if pl.is_shard() and pl.dim == dim:
            idx = idx * mesh.size(m) + mesh.get_local_rank(m)
    return idx * local_size


def shard_dims(placements, dim: int) -> list:
    """The mesh dimensions that shard tensor dimension ``dim``."""
    return [m for m, pl in enumerate(placements)
            if pl.is_shard() and pl.dim == dim]


def run_local(fn, mesh, primary, inputs, out_placements):
    """Run ``fn`` on this process's shards (the reference's ``shard_map``
    region) and wrap its outputs as DTensors.

    ``inputs``: ``(x, placements)`` pairs.  A DTensor is redistributed to
    ``placements`` and passed as its local shard; a plain tensor with
    placements is a full tensor every process holds alike (a constant) and
    is sliced; ``(x, None)`` passes ``x`` as it is.  ``primary`` is the
    placement of the region's data: the gradient of a DTensor input that is
    replicated on a mesh dimension where ``primary`` is sharded differs
    from process to process, so it is taken as ``Partial`` there (summed
    in backward); elsewhere it keeps the input's placements.
    ``out_placements``: one list a returned tensor (``fn`` returns a
    tensor or a tuple); empty where ``fn`` works in place and returns
    nothing.
    """
    args = []
    for x, pl in inputs:
        if pl is None:
            args.append(x)
        elif is_dtensor(x):
            if tuple(x.placements) != tuple(pl):
                x = x.redistribute(mesh, pl)
            grad = [Partial() if (p.is_replicate() and q.is_shard()) else p
                    for p, q in zip(pl, primary)]
            args.append(x.to_local(grad_placements=grad))
        else:
            args.append(local_slice(x, mesh, pl))
    out = fn(*args)
    if not out_placements:
        return None
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    wrapped = tuple(
        DTensor.from_local(o.contiguous(), mesh, pl, run_check=False,
                           shape=global_shape(o.shape, mesh, pl),
                           stride=_contiguous_stride(
                               global_shape(o.shape, mesh, pl)))
        for o, pl in zip(outs, out_placements))
    return wrapped[0] if single else wrapped


def shard_bytes(t) -> int:
    """Bytes this process holds of ``t`` (its local shard for a DTensor)."""
    local = t.to_local() if is_dtensor(t) else t
    return local.numel() * local.element_size()


def spec_bytes(shape, itemsize: int, mesh, spec) -> int:
    """Bytes a process holds of a ``shape`` tensor placed by ``spec`` (any
    mesh :func:`axis_sizes` reads, a stand-in with no devices included)."""
    sizes = axis_sizes(mesh)
    n = itemsize
    for dim, entry in zip(shape, spec):
        group = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        for a in group:
            dim //= sizes[a]
        n *= dim
    return n


# -- the context the model code reads ------------------------------------------------

class ShardCtx:
    """A mesh and its rules, as the model code sees them (the reference's
    ``ShardCtx``): with no mesh every method leaves its tensor alone, so
    the single-device path runs unchanged."""

    def __init__(self, mesh=None, rules: dict | None = None):
        self.mesh = mesh
        self.rules = rules if rules is not None or mesh is None \
            else make_rules()

    def __repr__(self):
        return f"ShardCtx(mesh={self.mesh!r}, rules={self.rules!r})"

    @property
    def on(self) -> bool:
        return self.mesh is not None

    def constrain(self, x, axes):
        if self.mesh is None:
            return x
        return constrain(x, self.mesh, axes, self.rules)

    def placements(self, axes, shape) -> list:
        return sharding_for(self.mesh, axes, self.rules, tuple(shape))

    def place(self, t, axes):
        """A full tensor every process holds alike → a DTensor placed by
        its logical axes (no communication); ``t`` without a mesh."""
        if self.mesh is None or is_dtensor(t):
            return t
        return from_full(t, self.mesh, self.placements(axes, t.shape))

    def zeros(self, shape, axes, dtype, device):
        """Zeros placed by logical axes, each process allocating its shard
        only."""
        if self.mesh is None:
            return torch.zeros(shape, dtype=dtype, device=device)
        pl = self.placements(axes, shape)
        local = torch.zeros(local_shape(shape, self.mesh, pl), dtype=dtype,
                            device=device)
        return DTensor.from_local(local, self.mesh, pl, run_check=False,
                                  shape=tuple(shape),
                                  stride=_contiguous_stride(shape))

    def full(self, x):
        """A DTensor gathered whole (a plain tensor as it is)."""
        return x.full_tensor() if is_dtensor(x) else x


NULL_CTX = ShardCtx()


# -- collectives the regions call ------------------------------------------------------

def _all_to_all_raw(x, group):
    import torch.distributed as dist
    src = x.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out


def all_to_all(x, group, n: int):
    """``all_to_all_single`` over ``group`` (``n`` processes), with
    autograd: x's leading dimension splits into ``n`` equal chunks, chunk
    ``j`` goes to process ``j``, and the chunks received are stacked in
    process order.  The exchange is its own inverse, so the backward
    sends the gradient's chunks back the same way."""

    class _A2A(torch.autograd.Function):
        @staticmethod
        def forward(ctx_, t):
            return _all_to_all_raw(t, group)

        @staticmethod
        def backward(ctx_, g):
            return _all_to_all_raw(g, group)

    if n == 1:
        return x
    return _A2A.apply(x)
