"""Transaction datasets (copies of the JAX package's generator and loader)."""

from .generator import ibm_generator, chess_like, mushroom_like, dataset_by_name
from .loader import load_transactions, save_transactions, dataset_stats

__all__ = [
    "ibm_generator", "chess_like", "mushroom_like", "dataset_by_name",
    "load_transactions", "save_transactions", "dataset_stats",
]
