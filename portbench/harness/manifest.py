"""Find a cell's pieces by name: ``BENCHMARK.json`` names the cell's
configuration and traffic mix, and ``configs/``, ``traffic/``, ``drivers/``
and ``metrics/`` hold one file each.  Adding a cell, a mix or a metric adds
files and entries; no file here changes."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

from .env import BENCH, ROOT


class Manifest:
    def __init__(self, path: str | None = None):
        with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
            self.doc = json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == cell["config"]:
                with open(os.path.join(ROOT, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no configuration {cell['config']!r}")

    def end_to_end(self, cell: dict) -> list:
        return [m for m in self.doc["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def per_layer(self, cell: dict) -> list:
        return [m for m in self.doc["per_layer"]
                if cell["name"] in m.get("workloads", [cell["name"]])]


def traffic(name: str) -> dict:
    with open(os.path.join(BENCH, "traffic", f"{name}.json")) as f:
        return json.load(f)


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def reader(metric: str):
    """The ``read(record)`` function of ``metrics/<metric>.py``."""
    path = os.path.join(BENCH, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
