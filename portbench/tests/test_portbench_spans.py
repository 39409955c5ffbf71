"""The readers of the program's spans (`portbench/spans.py` and the five
metrics that use it) on a made-up host-op stretch, checked by hand; with no
span they read nothing; on a real profile of the program they find its
spans."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from portbench import harness, spans, variants

SPANNED = ["program_idle_ms.infer", "program_idle_ms.train", "syncs.infer", "syncs.train",
           "update_launches.train"]


def made_up() -> dict:
    # two requests. Request 1: ssd3d.infer over 100-400 us, the card busy 50-150
    # and 300-350 (idle inside the span: 150-300 and 350-400, 200 us). Request 2:
    # over 500-700, busy 450-800 (none idle). A stream synchronise inside each,
    # a blocking copy inside the first, one outside both (the harness's).
    # A step's update span over 900-1000 holds two kernel launches and a copy.
    host = [(100.0, 400.0, "ssd3d.infer"), (120.0, 130.0, "cudaLaunchKernel"),
            (200.0, 210.0, "cudaStreamSynchronize"), (220.0, 221.0, "cudaMemcpy"),
            (230.0, 231.0, "cudaMemcpyAsync"), (500.0, 700.0, "ssd3d.infer"),
            (600.0, 610.0, "cudaStreamSynchronize"), (800.0, 810.0, "cudaDeviceSynchronize"),
            (900.0, 1000.0, "ssd3d.train.update"), (910.0, 911.0, "cudaLaunchKernel"),
            (920.0, 921.0, "cudaLaunchKernelExC"), (930.0, 931.0, "cudaMemsetAsync"),
            (940.0, 941.0, "cudaLaunchHostFunc")]
    return {"requests": 2, "host": sorted(host),
            "labelled": [[50.0, 150.0], [300.0, 350.0], [450.0, 800.0]]}


def test_span_readings_by_hand():
    tr = made_up()
    assert spans.idle_ms(tr, "ssd3d.infer") == pytest.approx(0.1)  # 200 us over 2 requests
    assert spans.calls(tr, "ssd3d.infer", spans.SYNC) == 1.5  # 3 over 2 requests
    assert spans.calls(tr, "ssd3d.train.update", spans.LAUNCH) == 1.0
    assert spans.idle_ms(tr, "ssd3d.train.step") is None


def test_readers_on_a_made_up_trace():
    run = SimpleNamespace(trace=made_up())
    got = {name: harness.read_metric(name, run) for name in SPANNED}
    assert got == {"program_idle_ms.infer": pytest.approx(0.1), "program_idle_ms.train": None,
                   "syncs.infer": 1.5, "syncs.train": None, "update_launches.train": 1.0}


def test_names_the_runtime_calls_as_blocking_or_launching():
    for name in ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                 "cudaMemcpy", "cudaMemcpy2D", "cuStreamSynchronize", "cuCtxSynchronize"):
        assert spans.SYNC.match(name), name
    for name in ("cudaMemcpyAsync", "cudaStreamWaitEvent", "cudaLaunchKernel", "cudaMalloc",
                 "cudaEventRecord", "cudaStreamSynchronizeX"):
        assert not spans.SYNC.match(name), name
    for name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                 "cudaLaunchCooperativeKernel", "cudaLaunchKernelExC_v11060"):
        assert spans.LAUNCH.match(name), name
    for name in ("cudaLaunchHostFunc", "cudaMemsetAsync", "cudaMemcpyAsync"):
        assert not spans.LAUNCH.match(name), name


@pytest.mark.parametrize("name", SPANNED)
def test_without_spans_a_reader_reads_nothing(name):
    # a program that opens no span (the parent of the spans): the metric is left out
    tr = made_up()
    tr["host"] = [h for h in tr["host"] if not h[2].startswith("ssd3d.")]
    assert harness.read_metric(name, SimpleNamespace(trace=tr)) is None


def test_the_program_opens_the_spans_the_readers_read():
    # the shrunk 3DSSD cell's program on the CPU under a profiler of host ops,
    # reduced as Tracer.read reduces its second stretch; no card, so no device
    # interval: the whole root span is idle
    from ssd3d_torch.config import Config
    from ssd3d_torch.models.api import build_pipeline

    cell = variants.shrunk(harness.Cell.load(harness.benchmark(), "3dssd-infer-b8"), 8)
    pipe = build_pipeline(Config(cell.cfg), device="cpu")
    points = torch.rand(1, cell.cfg["MODEL"]["POINTS_NUM_FOR_TRAINING"], 4) * 20.0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pipe.infer(points)
    host = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.device_type != torch.autograd.DeviceType.CUDA)
    tr = {"requests": 1, "host": host, "labelled": []}
    (start, end), = spans.spans(tr, "ssd3d.infer")
    assert spans.idle_ms(tr, "ssd3d.infer") == pytest.approx((end - start) / 1e3)
    assert spans.calls(tr, "ssd3d.infer", spans.SYNC) == 0.0
