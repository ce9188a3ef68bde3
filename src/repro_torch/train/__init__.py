"""Training of the port on one device: the policy-fused ``TrainLoop`` and
the JAX package's checkpoint format (``reshard_state``/``restore_elastic``
wait for the sharding slice)."""

from .loop import TrainLoop, init_train_state, make_train_step
from .checkpoint import save_checkpoint, load_checkpoint, all_steps

__all__ = ["TrainLoop", "init_train_state", "make_train_step",
           "save_checkpoint", "load_checkpoint", "all_steps"]
