"""Shared measurement + persistence layer (DESIGN.md §9).

The port's copy of the JAX package's ``costmodel/measure.py``:

* :func:`time_once` — the warm-up + best-of-reps timing loop; it waits for
  the card with ``torch.cuda.synchronize()``;
* :func:`cache_dir` / :class:`JsonStore` — best-effort JSON persistence under
  ``~/.cache/repro_torch/``.  The port never writes the reference's
  ``~/.cache/repro/`` stores;
* :func:`device_key` — the ``type:device_name`` identity that keys the fits
  (``cuda:NVIDIA-H100-80GB-HBM3``, ``cpu:cpu``): two different cards must
  not share timings.
"""

from __future__ import annotations

import json
import os
import re

import torch


def cache_dir() -> str:
    """Directory of the port's persisted cost-model fits."""
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch")


def device_key(device=None) -> str:
    """``type:device_name`` cache identity of ``device`` (default: the card
    when one is present, else the CPU)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        name = (torch.cuda.get_device_name(dev) if torch.cuda.is_available()
                else "unknown")
    else:
        name = dev.type
    name = re.sub(r"[^A-Za-z0-9_.]+", "-", str(name)).strip("-") or "unknown"
    return f"{dev.type}:{name}"


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_once(fn, reps: int = 2, clock=None) -> float:
    """Best-of-``reps`` wall time of ``fn()`` after one warm-up call.

    Every timed call ends in ``torch.cuda.synchronize()`` (a no-op without a
    card), so the number is device time + launch overhead, not the enqueue.
    ``clock`` is any object with ``now() -> float`` seconds (DESIGN.md §13);
    default the monotonic wall clock.
    """
    if clock is None:
        from repro_torch.obs.clock import MonotonicClock
        clock = MonotonicClock()
    fn()                            # warm-up: first launch, kernel build
    _sync()
    best = float("inf")
    for _ in range(max(reps, 1)):
        t0 = clock.now()
        fn()
        _sync()
        best = min(best, clock.now() - t0)
    return best


class JsonStore:
    """Best-effort persisted JSON dict (atomic replace; errors never raise).

    The in-memory dict is authoritative for the process; disk is a warm-start
    for the next one.
    """

    def __init__(self, path: str):
        self.path = path

    def load(self) -> dict:
        try:
            with open(self.path) as f:
                out = json.load(f)
            return out if isinstance(out, dict) else {}
        except (OSError, ValueError):
            return {}

    def save(self, store: dict) -> None:
        try:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            # one temporary name a process: processes that write one store
            # at once (a mesh's ranks at exit) never interleave their bytes
            tmp = f"{self.path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(store, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except OSError:
            pass


def costmodel_store() -> JsonStore:
    """The persisted cost-model fit store (override with
    ``REPRO_TORCH_COSTMODEL_CACHE``)."""
    env = os.environ.get("REPRO_TORCH_COSTMODEL_CACHE")
    path = env if env else os.path.join(cache_dir(), "costmodel.json")
    return JsonStore(path)
