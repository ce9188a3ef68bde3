"""A new configuration, traffic mix and per-layer metric are found by name,
with no existing file edited."""

import json
import os
import shutil

from portbench.harness import manifest as mf
from portbench.harness.env import BENCH, ROOT
from portbench.harness.window import Record


def test_new_pieces_are_found_by_name(tmp_path, monkeypatch):
    bench = tmp_path / "portbench"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(BENCH, sub), bench / sub)
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        doc = json.load(f)
    doc["configs"].append({"name": "tiny", "source": "https://example.org",
                           "file": "portbench/configs/tiny.json",
                           "reduced": [], "why": "a test's configuration"})
    doc["workloads"].append({"name": "mine.tiny", "config": "tiny",
                             "traffic": "tiny_loop", "chips": 1,
                             "why": "a test's cell"})
    doc["per_layer"].append({"name": "mines.tiny", "unit": "mines",
                             "better": "higher", "source": "program_counter",
                             "layer": "phase", "moves": "mine_s",
                             "workloads": ["mine.tiny"]})
    for m in doc["end_to_end"]:
        if "workloads" in m and m["name"] == "mine_s":
            m["workloads"].append("mine.tiny")
    (bench / "configs" / "tiny.json").write_text(json.dumps(
        {"dataset": {"generator": "attribute_value", "n_txns": 64,
                     "value_counts": [2, 3], "skew": 1.0, "data_seed": 0},
         "mine": {"min_sup": 0.3, "algorithm": "spc", "impl": "jnp"}}))
    (bench / "traffic" / "tiny_loop.json").write_text(json.dumps(
        {"driver": "mine_loop", "warmup_mines": 1}))
    (bench / "metrics" / "mines.tiny.py").write_text(
        "def read(rec):\n    return rec.counters['mines']\n")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    monkeypatch.setattr(mf, "ROOT", str(tmp_path))
    monkeypatch.setattr(mf, "BENCH", str(bench))

    man = mf.Manifest()
    cell = man.cell("mine.tiny")
    assert man.config(cell)["dataset"]["n_txns"] == 64
    assert mf.traffic(cell["traffic"])["driver"] == "mine_loop"
    assert mf.driver("mine_loop").run
    assert [m["name"] for m in man.end_to_end(cell)] == ["mine_s", "setup_s"]
    assert [m["name"] for m in man.per_layer(cell)] == ["mines.tiny"]
    rec = Record(spans=[], counters={"mines": 7}, chips=[], window_s=1.0,
                 work=[])
    assert mf.reader("mines.tiny")(rec) == 7
    assert all(p.read_bytes() == b for p, b in before.items())
