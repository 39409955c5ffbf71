"""The readers of the program's spans (`portbench/spans.py` and the
metrics that use it) on a made-up host-op stretch, checked by hand; with no
span they read nothing; on a real profile of the program they find its
spans. The device time under each span (`trace.span_device_us`) on made-up
profiler events, against the port's own reduction of the same events."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from portbench import harness, spans, trace, variants

SPANNED = ["program_idle_ms.infer", "program_idle_ms.train", "syncs.infer", "syncs.train",
           "update_launches.train", "roi_pool_ms.infer"]


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
    # The RoI pool's spans (one a request) hold 600 us of device work in 4 kernels.
    return {"requests": 2, "host": sorted(host),
            "labelled": [[50.0, 150.0], [300.0, 350.0], [450.0, 800.0]],
            "span_us": {"ssd3d.infer": [900.0, 9], "ssd3d.rcnn.pool": [600.0, 4]}}


def test_span_readings_by_hand():
    tr = made_up()
    assert spans.idle_ms(tr, "ssd3d.infer") == pytest.approx(0.1)  # 200 us over 2 requests
    assert spans.calls(tr, "ssd3d.infer", spans.SYNC) == 1.5  # 3 over 2 requests
    assert spans.calls(tr, "ssd3d.train.update", spans.LAUNCH) == 1.0
    assert spans.idle_ms(tr, "ssd3d.train.step") is None
    assert spans.device_ms(tr, "ssd3d.rcnn.pool") == pytest.approx(0.3)
    assert spans.device_ms(tr, "ssd3d.rcnn") is None


def test_readers_on_a_made_up_trace():
    run = SimpleNamespace(trace=made_up())
    got = {name: harness.read_metric(name, run) for name in SPANNED}
    assert got == {"program_idle_ms.infer": pytest.approx(0.1), "program_idle_ms.train": None,
                   "syncs.infer": 1.5, "syncs.train": None, "update_launches.train": 1.0,
                   "roi_pool_ms.infer": pytest.approx(0.3)}


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
    tr["span_us"] = {}
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
    span_us = trace.span_device_us([e for e in prof.events()
                                    if e.device_type != torch.autograd.DeviceType.CUDA])
    tr = {"requests": 1, "host": host, "labelled": [], "span_us": span_us}
    (start, end), = spans.spans(tr, "ssd3d.infer")
    assert spans.idle_ms(tr, "ssd3d.infer") == pytest.approx((end - start) / 1e3)
    assert spans.calls(tr, "ssd3d.infer", spans.SYNC) == 0.0
    # every span is found by name; without a card nothing runs under it
    assert {"ssd3d.infer", "ssd3d.backbone", "ssd3d.sa.mlp"} <= set(span_us)
    assert spans.device_ms(tr, "ssd3d.infer") == 0.0


def event(name, start, end, thread=1, kernels=(), children=()):
    """A made-up profiler event (the attributes of torch's FunctionEvent that
    the reductions read), its children's parent set to it."""
    e = SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                        thread=thread, device_type=torch.autograd.DeviceType.CPU,
                        kernels=[SimpleNamespace(name=k, duration=d) for k, d in kernels],
                        cpu_children=list(children), cpu_parent=None)
    for c in children:
        c.cpu_parent = e
    return e


def made_up_events() -> list:
    # thread 1: a request (0-1000 us) around ssd3d.infer (10-900), which holds an
    # add (a 50 us kernel) and two RoI pool spans (the RCNN's chunks): the first
    # (100-400) a top-k (a 30 us kernel) and a copy (5 us, not a kernel launch),
    # the second (500-600) a gather (20 us). Thread 2, the autograd engine's:
    # an outermost op at 150 (a 7 us kernel), inside both spans of thread 1,
    # and one at 950, inside none.
    pool1 = event("ssd3d.rcnn.pool", 100, 400, children=[
        event("aten::topk", 110, 120, kernels=[("topk_kernel", 30.0)]),
        event("aten::copy_", 130, 140, kernels=[("Memcpy DtoD (Device -> Device)", 5.0)])])
    pool2 = event("ssd3d.rcnn.pool", 500, 600, children=[
        event("ssd3d::gather", 510, 520, kernels=[("gather_kernel", 20.0)])])
    infer = event("ssd3d.infer", 10, 900, children=[
        event("aten::add", 20, 30, kernels=[("add_kernel", 50.0)]), pool1, pool2])
    request = event("portbench.request", 0, 1000, children=[infer])
    other = [event("autograd::engine::evaluate_function", 150, 160, thread=2,
                   kernels=[("bwd_kernel", 7.0)]),
             event("autograd::engine::evaluate_function", 950, 960, thread=2,
                   kernels=[("bwd_kernel", 3.0)])]
    found, stack = [], [request] + other
    while stack:
        e = stack.pop()
        found.append(e)
        stack += e.cpu_children
    return found


def test_span_device_time_by_hand():
    got = trace.span_device_us(made_up_events())
    # the pool: 30 + 5 + 7 (the other thread's) + 20 us, 3 kernels; the root:
    # those and the add's 50 us, 4 kernels; the op on thread 2 at 950 in neither
    assert got == {"ssd3d.rcnn.pool": [62.0, 3], "ssd3d.infer": [112.0, 4]}
    tr = {"requests": 2, "span_us": got}
    assert spans.device_ms(tr, "ssd3d.rcnn.pool") == pytest.approx(0.031)
    assert harness.read_metric("roi_pool_ms.infer", SimpleNamespace(trace=tr)) == \
        pytest.approx(0.031)


def test_span_device_time_is_the_ports_reduction():
    from ssd3d_torch.utils.profiling import span_device_times

    events = made_up_events()
    want = {name: [us, n] for name, (us, n) in span_device_times(events).items()}
    assert trace.span_device_us(events) == want
