"""Cells changed for the tests and for the readings the limits are set from
(`calibrate.py`): a shrunk configuration, another compute dtype or a
shorter mix; the control (the reference at a lower precision) or a fault
(`faults.py`) in the program's place. A benchmark run uses none of them."""

from __future__ import annotations

import dataclasses
import json

from portbench import faults, harness
from portbench.harness import Cell


def shrink_config(cfg: dict, k: int) -> dict:
    """A smaller copy for the CPU tests: the first stage's sampling counts
    and the scan divided by k, and the proposals too (widths unchanged)."""
    cfg = json.loads(json.dumps(cfg))
    for row in cfg["MODEL"]["NETWORK"]["FIRST_STAGE"]["ARCHITECTURE"]:
        row[6] = [r if r == -1 else r // k for r in row[6]]
        row[8] = [p if p == -1 else p // k for p in row[8]]
    cfg["MODEL"]["POINTS_NUM_FOR_TRAINING"] //= k
    if cfg["MODEL"]["TYPE"] == "DoubleStage":
        fs = cfg["MODEL"]["FIRST_STAGE"]
        fs["MAX_OUTPUT_NUM"] = max(4, fs["MAX_OUTPUT_NUM"] // k)
    return cfg


def with_mix(cell: Cell, **mix) -> Cell:
    """The mix's keys replaced by `mix`."""
    return dataclasses.replace(cell, mix=dict(cell.mix, **mix))


def shrunk(cell: Cell, k: int, **mix) -> Cell:
    """The configuration shrunk by k, the mix's keys replaced by `mix`."""
    return with_mix(dataclasses.replace(cell, conf=dict(cell.conf,
                                                        cfg=shrink_config(cell.cfg, k))), **mix)


def in_dtype(cell: Cell, dtype: str) -> Cell:
    """The program (and the reference that judges it) computing in `dtype`."""
    cfg = dict(cell.cfg, TPU=dict(cell.cfg["TPU"], COMPUTE_DTYPE=dtype))
    return dataclasses.replace(cell, conf=dict(cell.conf, cfg=cfg))


def control(cell: Cell, prec: str) -> Cell:
    """The reference at precision `prec` ("fp8", "tf32") in the program's place."""
    loop = harness.load_loop(cell.mix["kind"])
    return dataclasses.replace(cell, make_program=lambda r: loop.make_control(r, prec))


def faulty(cell: Cell, name: str) -> Cell:
    """The fault `name` of `faults.FAULTS` planted under the timed path."""
    base = cell.make_program or harness.load_loop(cell.mix["kind"]).make_program

    def make(r):
        program = base(r)
        return None if program is None else faults.FAULTS[name](program)
    return dataclasses.replace(cell, make_program=make)
