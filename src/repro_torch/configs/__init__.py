"""Arch configs: one module per assigned architecture + shape definitions.

The port's plain-data copy of the JAX package's ``configs/``: the same
dataclasses and values, so a config built by either package has equal
fields (``tests/test_torch_models.py`` holds all ten archs).
"""

from .base import (ARCH_IDS, ARCH_NAMES, SHAPES, SUBQUADRATIC_ARCHS,
                   ModelConfig, ShapeConfig, cell_is_runnable, get_config)

__all__ = [
    "ARCH_IDS", "ARCH_NAMES", "SHAPES", "SUBQUADRATIC_ARCHS",
    "ModelConfig", "ShapeConfig", "cell_is_runnable", "get_config",
]
