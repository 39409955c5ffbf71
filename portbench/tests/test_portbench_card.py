"""The command itself on the card: each cell of BENCHMARK.json for a short
window, traced, prints a result line of the agreed shape and comes out
correct. Marked `cuda`; skips where there is no card.

    python -m pytest portbench/tests -m cuda -p no:cacheprovider
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def cards():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cells run the port's CUDA kernels")
    return torch.cuda.device_count()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in harness.benchmark()["workloads"]])
def test_a_traced_run_of_each_cell(cell, cards):
    chips = harness.cell_entry(harness.benchmark(), cell)["chips"]
    if cards < chips:
        pytest.skip(f"{cell} needs {chips} cards")
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                          str(2**31 + 3), "--seconds", "2", "--trace", "1"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], res.stderr[-2000:]
    assert list(out)[-1] == "checks"
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == chips
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    names = {m["name"] for m in harness.metrics_of(harness.benchmark(), cell, True)}
    assert set(out["metrics"]) == names
    assert len(out["breakdown"]["device_ops"]) <= 10
