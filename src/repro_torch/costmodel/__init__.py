"""The port's calibrated cost model (DESIGN.md §9): ``measure`` (timing,
persistence, device identity), ``model`` (per-key affine fits) and
``controller`` (the mining loop's decisions)."""

from .controller import CostController, Decision
from .measure import JsonStore, cache_dir, costmodel_store, device_key, time_once
from .model import AffineFit, CostModel, default_model

__all__ = [
    "AffineFit", "CostModel", "CostController", "Decision", "JsonStore",
    "cache_dir", "costmodel_store", "default_model", "device_key",
    "time_once",
]
