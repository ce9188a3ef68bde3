"""Elastic scaling: checkpoints are topology-free, so a job can restart on a
different mesh (more or fewer data-parallel replicas, another model split)
by placing the restored state onto the new mesh — the port's copy of the
JAX package's ``train/elastic.py``.

``reshard_state`` is the single primitive: a host tree in the reference's
layout + a model on the new mesh → the training state there, each process
keeping its shards.  Scale-down and scale-up are both restore-with-new-mesh.
"""

from __future__ import annotations

from repro_torch.models import convert
from repro_torch.train import checkpoint as ckpt_lib


def reshard_state(tree: dict, model, opt_cfg, mesh=None, rules=None) -> dict:
    """Place a host-side ``{params, opt}`` tree (the reference's layout, as
    ``checkpoint.load_checkpoint`` returns it) onto ``model``'s mesh — or
    onto ``mesh``/``rules``, where the model is placed first — and return
    the training state."""
    from repro_torch.train.loop import init_train_state
    state = init_train_state(model, opt_cfg, seed=None, mesh=mesh,
                             rules=rules)
    convert.load_reference_state(model, tree, state)
    return state


def restore_elastic(ckpt_dir: str, model, opt_cfg, mesh=None, rules=None,
                    template=None):
    """Load the newest checkpoint and place it on (a possibly different)
    mesh.  Returns (state, step) or (None, None) when no checkpoint
    exists."""
    tree, step = ckpt_lib.load_checkpoint(ckpt_dir, template=template)
    if tree is None:
        return None, None
    return reshard_state(tree, model, opt_cfg, mesh, rules), step
