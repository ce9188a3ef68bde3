"""A short run of every one-card cell on the card (``-m gpu``)."""

import json
import os
import subprocess
import sys

import pytest

from portbench.harness.env import ROOT


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["mine.c20d200k", "mine.mushroom",
                                  "serve.mushroom-4t"])
def test_one_card_cell_runs_correct(card, cell):
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
         "--workload", cell, "--seed", "3000000001", "--seconds", "2",
         "--trace", "1"], capture_output=True, text=True, timeout=600,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
