"""The harness's cells driven on the CPU at a shrunk size: every cell of
BENCHMARK.json comes out correct with the program as it is, and comes out
not correct with the control (the reference at the next lower precision in
the program's place) and with each fault a cell can have planted in its
timed path.

    pytest portbench/tests
"""

from __future__ import annotations

import time

import pytest
import torch

from portbench import harness, variants

CPU = torch.device("cpu")
SMALL = {"batch": 2, "pool": 8, "warmup": 1, "judged": 2, "min_requests": 2}
SHRINK = 8
SEED = 2**31 + 11  # past 32 signed bits, as a benchmark run's seed may be
# cells of one process (a data-parallel cell runs in test_portbench_ranks.py)
CELLS = [w["name"] for w in harness.benchmark()["workloads"]
         if harness.loadgen.load(w["traffic"]).get("ranks", 1) == 1]
CONTROL = {"bfloat16": "fp8", "float32": "tf32"}
# the faults each kind of cell can have
FAULTS = {"offline": ["half", "altered"], "train": ["half_step", "half_rows", "unchanged"]}


def small(name: str) -> harness.Cell:
    return variants.shrunk(harness.Cell.load(harness.benchmark(), name), SHRINK, **SMALL)


def run(cell: harness.Cell) -> dict:
    return harness.run(cell, SEED, 0.0, False, CPU, time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_cpu(cell):
    out = run(small(cell))
    assert out["correct"], out["_lines"]
    assert out["attempted"] >= 2 and out["failed"] == 0
    names = {m["name"] for m in harness.metrics_of(harness.benchmark(), cell, False)}
    assert set(out["metrics"]) == names
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert [k for k in out if k != "_lines"][-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    c = small(cell)
    out = run(variants.control(c, CONTROL[c.cfg["TPU"]["COMPUTE_DTYPE"]]))
    assert not out["correct"], out["_lines"]


def kind(cell: str) -> str:
    return harness.loadgen.load(harness.cell_entry(harness.benchmark(), cell)["traffic"])["kind"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in FAULTS[kind(c)]])
def test_fault_in_the_timed_path_is_not_correct(cell, fault):
    out = run(variants.faulty(small(cell), fault))
    assert not out["correct"], out["_lines"]
    assert out["failed"] > 0


@pytest.mark.parametrize("cell", [c for c in CELLS if kind(c) == "train"])
def test_half_the_rows_in_a_whole_batch_fail_a_number(cell):
    # the batch keeps its shape, so the guard on the forward's rows passes: a
    # number past its limit has to catch it
    out = run(variants.faulty(small(cell), "half_rows"))
    over = [k for k, c in out["checks"].items()
            if isinstance(c["value"], float) and c["value"] > c["limit"]]
    assert over and "rows of a batch" not in out["_lines"][1], out["_lines"]
