"""Optimizers of the port: AdamW (the JAX package's ``optim``), on one
device or on a mesh."""

from .adamw import (AdamWConfig, apply_updates, compress_grads, global_norm,
                    init_state, schedule, state_axes)

__all__ = ["AdamWConfig", "apply_updates", "compress_grads", "global_norm",
           "init_state", "schedule", "state_axes"]
