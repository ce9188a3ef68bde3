"""Transaction datasets and the LM token stream (copies of the JAX package's
generator, loader and token pipeline)."""

from .generator import ibm_generator, chess_like, mushroom_like, dataset_by_name
from .loader import load_transactions, save_transactions, dataset_stats
from .tokens import TokenPipeline

__all__ = [
    "ibm_generator", "chess_like", "mushroom_like", "dataset_by_name",
    "load_transactions", "save_transactions", "dataset_stats", "TokenPipeline",
]
