"""Optimizers of the port: AdamW (the JAX package's ``optim``, one device)."""

from .adamw import (AdamWConfig, apply_updates, compress_grads, global_norm,
                    init_state, schedule)

__all__ = ["AdamWConfig", "apply_updates", "compress_grads", "global_norm",
           "init_state", "schedule"]
