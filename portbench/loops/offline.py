"""Kind "offline": one client, one request in flight (a closed loop).

Set-up draws a pool of `pool` distinct scans from the seed (`loadgen`);
request i takes the next `batch` scans of the pool in turn, from the host
tensors (pinned, as a loader pins its batches; the host-to-device copy is
part of the request) to the detections on the host (the device-to-host copy
ends it). After the window, the requests the seed picked (`judged`) are
judged layer by layer against the reference (`judge.py`).

Mix keys: `batch`, `pool`, `max_cars`, `warmup` (requests of set-up),
`judged`, `trace_from`, `trace_requests`; `min_requests` (tests only).
"""

from __future__ import annotations

import time

import torch

from portbench import harness, judge, loadgen
from portbench.capture import Recorder
from portbench.reference import nets
from portbench.trace import Tracer


class PortProgram:
    """The program under test: the port's pipeline through its normal entry,
    with a recorder on every module the reference judges."""

    def __init__(self, r):
        from ssd3d_torch.config import Config
        from ssd3d_torch.models.api import build_pipeline
        cell = r.cell
        self.pipeline = build_pipeline(Config(cell.cfg), nms_pre_topk=cell.conf["nms_pre_topk"],
                                       device=r.device)
        self.pipeline.model.load_state_dict(r.w, strict=True)
        self.model = self.pipeline.model
        self.recorder = Recorder(self.model, judge.watched_modules(r.det), cell.mix["judged"],
                                 r.seed)

    def infer(self, points: torch.Tensor) -> dict:
        return self.pipeline.infer(points)


class ReferenceProgram:
    """The reference put in the program's place at precision `prec` (the
    control), writing its layers' outputs where the recorder reads them."""

    def __init__(self, r, prec: str):
        self.det = r.det
        self.params = nets.Params(r.w, r.det.bf16, prec)
        self.recorder = Recorder(torch.nn.Module(), [], r.cell.mix["judged"], r.seed)

    def infer(self, points: torch.Tensor) -> dict:
        cur = self.recorder.current
        with torch.inference_mode():
            return self.det.forward(self.params, points,
                                    record=cur["outputs"] if cur is not None else None)


make_program = PortProgram
make_control = ReferenceProgram


def _well_formed(dets: dict, batch: int) -> bool:
    boxes = dets["boxes"]
    return (boxes.shape[0] == batch and bool(torch.isfinite(boxes).all())
            and bool(torch.isfinite(dets["scores"]).all()))


def window(program, mix: dict, pool: dict, device: torch.device, seconds: float,
           recorder=None, tracer=None, warmup: bool = False) -> loadgen.Window:
    """Closed-loop batches until `seconds` have passed (each request started
    before then runs to its end and counts); with `warmup`, just
    `mix["warmup"]` requests. The tracer, if any, profiles its stretches."""
    points = pool["points"]
    w = loadgen.Window()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    w.t0 = time.perf_counter()
    i = 0
    while True:
        if warmup:
            if i >= mix["warmup"]:
                break
        elif (time.perf_counter() - w.t0 >= seconds and i >= mix.get("min_requests", 0)
              and (tracer is None or i >= tracer.last())):
            break
        if tracer is not None:
            tracer.before(i)
        rows = loadgen.request_rows(mix, i)
        slot = recorder.begin() if recorder is not None else None
        start = time.perf_counter()
        with torch.profiler.record_function("portbench.request"):
            with torch.profiler.record_function("portbench.h2d"):
                x = points[rows].to(device)
            dets = program.infer(x)
            with torch.profiler.record_function("portbench.d2h"):
                host = {k: v.cpu() for k, v in dets.items()}
        end = time.perf_counter()
        if recorder is not None:
            recorder.end(slot, {"rows": rows, "dets": dets})
        if tracer is not None:
            tracer.after(i)
        w.starts.append(start)
        w.ends.append(end)
        w.scans.append(mix["batch"])
        w.failed += 0 if _well_formed(host, mix["batch"]) else 1
        i += 1
    w.t1 = time.perf_counter()
    return w


def run(r) -> dict:
    cell, mix, device = r.cell, r.cell.mix, r.device
    program = (cell.make_program or make_program)(r)
    recorder = program.recorder
    r.marks["program"] = time.perf_counter() - r.t_start
    pool = loadgen.make_pool(mix, r.seed, cell.cfg["MODEL"]["POINTS_NUM_FOR_TRAINING"], device)
    r.marks["scans"] = time.perf_counter() - r.t_start
    window(program, mix, pool, device, 0.0, warmup=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    tracer = Tracer(device, mix["trace_from"], mix["trace_requests"]) if r.trace else None
    setup_s = time.perf_counter() - r.t_start
    win = window(program, mix, pool, device, r.seconds, recorder, tracer)
    recorder.close()
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    tr = tracer.read() if tracer is not None else None
    program = None  # the program's state goes before the reference runs
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    verdict, bad = judge.judge_kept(r.det, nets.Params(r.w, r.det.bf16), recorder.kept, pool,
                                    device, cell.limits)
    t_judge = time.perf_counter() - t_judge
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in verdict.numbers().items()}
    correct = bool(recorder.kept) and all(c["value"] <= c["limit"] for c in checks.values())
    return harness.report(r, win, tr, setup_s, memory_peak, correct, win.failed + bad, checks, [
        f"judged {len(recorder.kept)} requests of {len(win.starts)}; worst at "
        f"{verdict.where or '-'} ({t_judge:.2f} s)"] + verdict.notes[:8], train=False)
