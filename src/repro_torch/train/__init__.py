"""Training of the port: the policy-fused ``TrainLoop`` on one device or a
mesh, the JAX package's checkpoint format, and elastic restarts onto
another mesh (``reshard_state``/``restore_elastic``)."""

from .loop import (TrainLoop, init_train_state, make_train_step,
                   state_shardings)
from .checkpoint import save_checkpoint, load_checkpoint, all_steps
from .elastic import reshard_state, restore_elastic

__all__ = ["TrainLoop", "init_train_state", "make_train_step",
           "state_shardings", "save_checkpoint", "load_checkpoint",
           "all_steps", "reshard_state", "restore_elastic"]
