"""The data-parallel training mix on the CPU: four processes over gloo,
the same harness code as on four cards, at a shrunk size and in float32
(where the reference follows the program to rounding). A sound run comes
out correct, and one whose gradients are never exchanged does not. The
cell is built from its files (`train_dp4`, `limits/3dssd-train-dp4.json`)
whether or not `BENCHMARK.json` holds it."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import ranks

ROOT = Path(__file__).resolve().parents[2]
# (cell, configuration, mix, chips)
CELLS = [("3dssd-train-dp4", "3dssd_kitti_car", "train_dp4", 4)]

RANK = """
import json, sys, time, torch
torch.set_num_threads(1)
from portbench import harness, variants
spec, fault, out_path = json.loads(sys.argv[1]), sys.argv[2], sys.argv[3]
cell = variants.in_dtype(variants.shrunk(harness.Cell.of(*spec), 8, batch=2, pool=32,
                                         min_requests=1), "float32")
if fault != "none":
    cell = variants.faulty(cell, fault)
out = harness.run(cell, 2**31 + 9, 0.0, False, torch.device("cpu"), time.perf_counter())
if out is not None:
    out.pop("_lines")
    open(out_path, "w").write(json.dumps(out))
if torch.distributed.is_initialized():
    torch.distributed.destroy_process_group()
"""


def run_ranks(cell: tuple, fault: str, tmp_path) -> dict:
    chips = cell[3]
    env = dict(os.environ, PYTHONPATH=str(ROOT), SSD3D_DIST_NUM_PROCESSES=str(chips),
               SSD3D_DIST_COORDINATOR=f"localhost:{ranks.free_port()}")
    out = tmp_path / "result.json"
    procs = [subprocess.Popen([sys.executable, "-c", RANK, json.dumps(cell), fault, str(out)],
                              cwd=ROOT,
                              env=dict(env, SSD3D_DIST_PROCESS_ID=str(r)))
             for r in range(chips)]
    assert ranks.stop(procs, seconds=600) == [0] * chips
    return json.loads(out.read_text())


@pytest.mark.parametrize("cell", CELLS, ids=[c[0] for c in CELLS])
def test_data_parallel_cell_on_the_cpu(cell, tmp_path):
    out = run_ranks(cell, "none", tmp_path)
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == cell[3]


@pytest.mark.parametrize("cell", CELLS, ids=[c[0] for c in CELLS])
def test_gradients_not_exchanged_are_not_correct(cell, tmp_path):
    out = run_ranks(cell, "no_exchange", tmp_path)
    assert not out["correct"], out["checks"]
