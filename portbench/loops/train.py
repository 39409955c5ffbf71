"""Kind "train": one optimizer step a request on the next `batch` scenes of
the pool (`loadgen`), each step ended by a synchronise of the card. Set-up
builds one train state and drives it through `checked_steps` steps, whose
results the reference follows after the window (`training.py`); the
window goes on stepping the same state. With `ranks`, each rank is one
process and card (`ranks.py`) and steps its rows of the global batch under
data parallelism; rank 0 judges and reports.

Mix keys: `batch` (a rank's), `pool`, `max_cars`, `checked_steps`,
`trace_from`, `trace_requests`, `ranks`; `min_requests` (tests only).
"""

from __future__ import annotations

import time

import torch

from portbench import harness, judge, loadgen, training
from portbench.reference import train as reference
from portbench.trace import Tracer


def make_program(r):
    det = r.det
    names = [f"{det.backbone.prefix}.{s}" for s, row in zip(det.backbone.scopes,
                                                             det.backbone.rows)
             if row[11] in ("SA_Layer", "Vote_Layer")]
    return training.PortTrainer(r.cell.cfg, r.cell.conf["nms_pre_topk"], r.w, r.device, names,
                                parallel="dp" if r.ranks > 1 else None,
                                watched=judge.watched_modules(det))


class ReferenceTrainer:
    """The reference put in the program's place at precision `prec` (the
    control). In a data-parallel cell it steps the global batch in rank 0's
    process alone."""

    whole_batch = True

    def __init__(self, r, prec: str):
        self.trainer = reference.Trainer(r.det, r.w, r.det.spec, prec)
        self.picks: dict = {}
        self.first: dict = {}
        self.outputs: dict = {}
        self.n = 0

    def stop_watching(self) -> None:
        pass

    def step(self, batch: dict) -> torch.Tensor:
        record: dict = {}
        out = self.trainer.step(batch, self.n, record=record)
        self.picks = {k: (v[2] if v[2].dtype == torch.int32 else v[0]).detach()
                      for k, v in record.items() if isinstance(v, tuple)}
        if self.n == 0:
            self.first = out["grads"]
            self.outputs = record
        self.n += 1
        return out["loss"]

    def leaves(self) -> dict:
        return {k: v.detach() for k, v in self.trainer.params.items()}

    def first_grad(self) -> dict:
        return self.first


def make_control(r, prec: str):
    return ReferenceTrainer(r, prec) if r.rank == 0 else None


def window(program, mix: dict, pool: dict, device: torch.device, seconds: float,
           tracer=None, rank: int | None = 0, go=None) -> loadgen.Window:
    """Steps until `seconds` have passed, on the batches after those of
    set-up. With several ranks, each takes its rows of the global batch and
    `go(more)` carries rank 0's decision to go on to every rank."""
    w = loadgen.Window()
    first = mix["checked_steps"]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    w.t0 = time.perf_counter()
    i = 0
    while True:
        more = not (time.perf_counter() - w.t0 >= seconds and i >= mix.get("min_requests", 0)
                    and (tracer is None or i >= tracer.last()))
        if go is not None:
            more = go(more)
        if not more:
            break
        if tracer is not None:
            tracer.before(i)
        start = time.perf_counter()
        with torch.profiler.record_function("portbench.request"):
            with torch.profiler.record_function("portbench.h2d"):
                batch = loadgen.train_batch(pool, mix, first + i, device, rank)
            loss = program.step(batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        end = time.perf_counter()
        if tracer is not None:
            tracer.after(i)
        w.starts.append(start)
        w.ends.append(end)
        w.scans.append(mix["batch"] * mix.get("ranks", 1))
        w.failed += 0 if bool(torch.isfinite(loss)) else 1
        i += 1
    w.t1 = time.perf_counter()
    return w


def run(r) -> dict | None:
    import torch.distributed as dist
    cell, mix, device = r.cell, r.cell.mix, r.device
    r.ranks = ranks = mix.get("ranks", 1)
    r.rank = rank = dist.get_rank() if ranks > 1 else 0
    program = (cell.make_program or make_program)(r)
    if program is None:  # this rank takes no part
        return None
    if getattr(program, "whole_batch", False):
        rank, ranks = None, 1
    r.marks["program"] = time.perf_counter() - r.t_start
    pool = loadgen.make_pool(mix, r.seed, cell.cfg["MODEL"]["POINTS_NUM_FOR_TRAINING"], device)
    r.marks["scans"] = time.perf_counter() - r.t_start
    kept = {"losses": [], "picks": []}
    for s in range(mix["checked_steps"]):
        kept["losses"].append(program.step(loadgen.train_batch(pool, mix, s, device, rank)))
        kept["picks"].append(training.gather_rows(dict(program.picks), ranks))
        if s == 0:
            kept["first_grad"] = {k: v.clone() for k, v in program.first_grad().items()}
            kept["outputs"] = training.gather_outputs(program.outputs, ranks)
    kept["leaves"] = {k: v.clone() for k, v in program.leaves().items()}
    kept["losses"] = [float(x) for x in kept["losses"]]
    program.stop_watching()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    tracer = Tracer(device, mix["trace_from"], mix["trace_requests"]) if r.trace else None
    setup_s = time.perf_counter() - r.t_start
    win = window(program, mix, pool, device, r.seconds, tracer, rank,
                 training.rank0_decides(device) if ranks > 1 else None)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    tr = tracer.read() if tracer is not None else None
    if ranks > 1:
        # the slowest rank's set-up and the fullest card's peak; the busy
        # time of each card for the device's line (its metric reads rank 0's)
        setup_s, memory_peak = training.across_ranks(device, max, setup_s, memory_peak)
        memory_peak = int(memory_peak)
        if tr is not None:
            tr["busy_s_mean"] = training.across_ranks(device, "mean", tr["busy_s"])[0]
        dist.barrier()
        if not cell.keep_group:  # every rank at once; rank 0 judges without it
            dist.destroy_process_group()
        if rank != 0:
            return None
    program = None  # the program's state goes before the reference runs
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    batches = [loadgen.train_batch(pool, mix, s, device, None)
               for s in range(mix["checked_steps"])]
    numbers, where = training.judge(r.det, r.w, kept, batches)
    t_judge = time.perf_counter() - t_judge
    checks = {k: {"value": numbers[k], "limit": v} for k, v in cell.limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    where += "; not compared: " + ", ".join(f"{k} {v:.4g}" for k, v in numbers.items()
                                           if k not in cell.limits)
    return harness.report(r, win, tr, setup_s, memory_peak, correct,
                          win.failed + (0 if correct else 1), checks,
                          [f"checked {mix['checked_steps']} steps ({t_judge:.2f} s): {where}"],
                          train=True)
