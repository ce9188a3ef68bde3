"""Small CPU versions of the cells, for the tests."""

from __future__ import annotations

import copy

from portbench.harness import env, manifest as mf

SMALL_TXNS = 3000       # c20d200k's rows in the CPU tests


MESH_CELL = {"name": "mine.c20d200k.x4", "config": "c20d200k",
             "traffic": "mine_mesh.4", "chips": 4,
             "why": "the mesh driver's cell, left out of BENCHMARK.json"}


def context(cell_name: str, seed: int = 2**33 + 11, seconds: float = 0.3,
            rate: float = 150.0):
    """A Context for ``cell_name`` on the CPU at a size a test can hold
    (``MESH_CELL``'s name gives the four-process mesh)."""
    from portbench.run import Context
    env.setup_caches()
    man = mf.Manifest()
    cell = (MESH_CELL if cell_name == MESH_CELL["name"]
            else man.cell(cell_name))
    config = copy.deepcopy(man.config(cell))
    if config["dataset"]["generator"] == "ibm_quest":
        config["dataset"]["n_txns"] = SMALL_TXNS
    traffic = mf.traffic(cell["traffic"])
    traffic.update({"warmup_mines": 1})
    if "rate_qps" in traffic:
        traffic.update({"rate_qps": rate, "warmup_s": 0.1})
        # the CPU's plain kernels are far slower than the card's: admit all
        config["serve"]["latency_slo_ms"] = 1e4
    return man, Context(cell=cell, config=config, traffic=traffic, seed=seed,
                        seconds=seconds, trace=False, device="cpu")


def run(man, ctx):
    from portbench.run import run as run_cell
    result, _ = run_cell(ctx, man, 0.0)
    return result
