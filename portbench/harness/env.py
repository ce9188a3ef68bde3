"""Process set-up shared by every run: import paths, cache directories, the
process's start time, the chip check and the check that no JAX was loaded.

Import this module before torch: it fixes the environment the port reads.
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "portbench")
CACHE = os.path.join(BENCH, ".cache")

# top-level module names no run may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def setup_paths() -> None:
    """The checkout's root (for ``portbench``) and ``src`` (the port) on
    ``sys.path``, ahead of the script's own directory."""
    for p in (os.path.join(ROOT, "src"), ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)
    here = os.path.dirname(os.path.abspath(sys.argv[0] or ""))
    if here == BENCH and here in sys.path:
        sys.path.remove(here)


def setup_caches() -> None:
    """Every cache of the port at a fixed path inside the checkout.

    The kernel builds already live in ``src/repro_torch/_build``.  The
    autotuner's plan persists between runs, so only a checkout's first run
    sweeps.  The cost model's fits start empty in every run (the file is
    removed here): the port saves them on every observation, so a kept file
    would make each run begin where the previous one ended.
    """
    os.makedirs(CACHE, exist_ok=True)
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(
        CACHE, "autotune.json")
    model = os.path.join(CACHE, "costmodel.json")
    os.environ["REPRO_TORCH_COSTMODEL_CACHE"] = model
    for path in (model, model + ".tmp"):
        if os.path.exists(path):
            os.remove(path)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def process_start() -> float:
    """This process's start on the ``time.perf_counter`` clock (Linux's
    ``/proc``; the moment of this call elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        now_boot = time.clock_gettime(time.CLOCK_BOOTTIME)
        return time.perf_counter() - (now_boot - started)
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter()


def require_cards(n: int) -> None:
    """Exit without a result unless ``n`` CUDA cards are visible."""
    import torch
    if not torch.cuda.is_available():
        sys.exit("portbench: torch sees no CUDA device")
    if torch.cuda.device_count() < n:
        sys.exit(f"portbench: the cell needs {n} CUDA devices, torch sees "
                 f"{torch.cuda.device_count()}")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})
