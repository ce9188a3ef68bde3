"""Model zoo of the port: the decoder with its dense, MoE (``moe``), SSM
(``ssm``) and hybrid layer stacks (``layers``, ``transformer``), the
encoder-decoder (``encdec``), the family facade (``model``) and the
carry-across of the JAX package's parameters (``convert``)."""

from .convert import load_reference_params
from .model import Model, build_model

__all__ = ["Model", "build_model", "load_reference_params"]
