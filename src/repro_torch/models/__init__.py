"""Model zoo of the port: the dense GQA decoder (``layers``,
``transformer``, ``model``) and the carry-across of the JAX package's
parameters (``convert``).  MoE, SSM, hybrid and encoder-decoder families
raise until their slices of the port arrive."""

from .convert import load_reference_params
from .model import Model, build_model

__all__ = ["Model", "build_model", "load_reference_params"]
