"""One run of one cell: build the program, make its weights and inputs from
the seed, warm up the cell's shapes, measure for a fixed time, judge what
the timed path produced against the reference, and report.

Everything that belongs to one configuration, traffic mix, kind of mix or
metric is a file of its own, found by the name `BENCHMARK.json` gives:
`configs/<config>.json`, `traffic/<mix>.json`, `loops/<kind>.py` (the
mix's `kind`: how its requests are driven and what is judged),
`metrics/<metric>.py` and `limits/<cell>.json` (the limit of each number
the judge compares).
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable

import torch

from portbench import loadgen, peaks, rooflines, weights
from portbench.reference import nets
from portbench.trace import breakdown

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level modules that may not be loaded in a run: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "ssd3d")


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (trace off) or per-layer ones (on)."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def load_config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def load_limits(cell: str) -> dict:
    return json.loads((HERE / "limits" / f"{cell}.json").read_text())


def load_loop(kind: str):
    """The module that drives a kind of mix: `loops/<kind>.py`."""
    if not (HERE / "loops" / f"{kind}.py").is_file():
        raise SystemExit(f"portbench: no loop for traffic kind {kind!r}")
    return importlib.import_module(f"portbench.loops.{kind}")


def read_metric(name: str, run) -> float | None:
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


@dataclasses.dataclass
class Cell:
    """What a run of a cell is built from: its files as `BENCHMARK.json`
    names them (`Cell.load`). The tests and `calibrate.py` run changed
    copies (`variants.py`)."""

    name: str
    chips: int
    conf: dict  # configs/<config>.json: `cfg`, the configuration tree as run
    mix: dict  # traffic/<mix>.json
    limits: dict  # limits/<cell>.json
    bench: dict = dataclasses.field(repr=False, default_factory=dict)
    # run(...) -> the program under test, or None where this rank takes no
    # part; None here: the port through its normal entry (the loop's own)
    make_program: Callable | None = None
    # a data-parallel cell's process group outlives the run (several runs in
    # one process)
    keep_group: bool = False

    @property
    def cfg(self) -> dict:
        return self.conf["cfg"]

    @classmethod
    def load(cls, bench: dict, name: str) -> "Cell":
        e = cell_entry(bench, name)
        return cls.of(name, e["config"], e["traffic"], e["chips"], bench)

    @classmethod
    def of(cls, name: str, config: str, traffic: str, chips: int = 1,
           bench: dict | None = None) -> "Cell":
        return cls(name, chips, load_config(config), loadgen.load(traffic), load_limits(name),
                   bench if bench is not None else benchmark())


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float) -> dict | None:
    """One run -> the result line's dict (and the lines for standard error
    under "_lines"); None on a rank other than 0 of a data-parallel run."""
    marks = {"imports": time.perf_counter() - t_start}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    loop = load_loop(cell.mix["kind"])
    if cell.mix.get("ranks", 1) > 1:
        # one rank of a data-parallel run: the process group from the
        # SSD3D_DIST_* variables the launcher set (run.py), this rank's card
        from ssd3d_torch.parallel.distributed import initialize_from_env, rank_device
        initialize_from_env(log=lambda _msg: None, device=device.type)
        device = rank_device(device.type)
    det = nets.Detector(cell.cfg, cell.conf["nms_pre_topk"])
    w = weights.make(det.spec, seed, device)
    marks["weights"] = time.perf_counter() - t_start
    return loop.run(SimpleNamespace(cell=cell, seed=seed, seconds=seconds, trace=trace,
                                    device=device, t_start=t_start, marks=marks, det=det, w=w))


def report(r, window, tr, setup_s, memory_peak, correct, failed, checks, notes,
           train: bool) -> dict:
    """The result line's dict, with the lines for standard error under
    "_lines": the metrics of the cell (trace off: end to end; on: per layer),
    each read by its own file."""
    cell, device = r.cell, r.device
    batch = cell.mix["batch"]
    m = SimpleNamespace(window=window, setup_s=setup_s, trace=tr, cfg=cell.cfg, batch=batch,
                        flops_per_request=rooflines.flops(cell.cfg, batch, train=train),
                        matmul_peak=peaks.MATMUL_PEAK[cell.cfg["TPU"]["COMPUTE_DTYPE"]])
    metrics = {}
    for spec in metrics_of(cell.bench, cell.name, tr is not None):
        value = read_metric(spec["name"], m)
        if value is not None and math.isfinite(value):
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.mix.get("ranks", 1), "memory_peak_bytes": memory_peak}
    if tr is not None:  # busy time averaged over the cards used
        dev["busy_s"], dev["window_s"] = tr.get("busy_s_mean", tr["busy_s"]), tr["window_s"]
    out = {"correct": correct, "attempted": len(window.starts), "failed": failed,
           "metrics": metrics, "device": dev}
    if tr is not None:
        out["breakdown"] = breakdown(tr)
    # strict JSON has no inf or NaN: a number that is not finite goes as text
    out["checks"] = {k: {"value": c["value"] if math.isfinite(c["value"]) else str(c["value"]),
                         "limit": c["limit"]} for k, c in checks.items()}
    r.marks["warm-up"] = setup_s
    lines = ["set-up at " + ", ".join(f"{k} {v:.2f} s" for k, v in r.marks.items())] + notes
    lines += [f"{k} {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]
    out["_lines"] = lines
    return out


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))
