"""BENCHMARK.json against the shape its format requires, and every piece
it names on disk."""

import json
import os
import re

import pytest

from portbench.harness.env import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


@pytest.fixture(scope="module")
def doc():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command(doc):
    assert set(doc) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert doc["paths"] == ["portbench"]
    assert doc["command"] == ["python3", "portbench/run.py"]
    assert 1 <= doc["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_text_fields(doc):
    names = []
    for c in doc["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/")
        names.append(c["name"])
    for w in doc["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        names.append(w["name"])
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in doc["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in SOURCES_E2E and 0.01 <= m["bound"] <= 0.25
    for m in doc["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
    assert len(names) == len(set(names))


def test_every_piece_is_on_disk(doc):
    cells = {w["name"] for w in doc["workloads"]}
    configs = {c["name"] for c in doc["configs"]}
    for c in doc["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in doc["workloads"]:
        assert w["config"] in configs
        path = os.path.join(BENCH, "traffic", f"{w['traffic']}.json")
        with open(path) as f:
            driver = json.load(f)["driver"]
        assert os.path.exists(os.path.join(BENCH, "drivers", f"{driver}.py"))
    readers = {f[:-3] for f in os.listdir(os.path.join(BENCH, "metrics"))
               if f.endswith(".py")}
    assert readers == {m["name"] for m in doc["per_layer"]}
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells


def test_each_cell_reports_setup_another_end_to_end_and_a_layer(doc):
    e2e = {m["name"] for m in doc["end_to_end"]}
    for w in doc["workloads"]:
        mine = {m["name"] for m in doc["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])}
        assert "setup_s" in mine and len(mine) >= 2
        layers = [m for m in doc["per_layer"]
                  if w["name"] in m.get("workloads", [w["name"]])]
        assert layers and all(m["moves"] in mine for m in layers)
    assert "setup_s" in e2e


def test_four_chip_cells_at_most_a_quarter_or_one(doc):
    four = sum(1 for w in doc["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(doc["workloads"]) // 4)
