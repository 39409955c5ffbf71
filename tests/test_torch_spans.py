"""The port's spans (`ssd3d_torch/utils/profiling.span`): under
`torch.profiler`, one `Pipeline.infer` of the tiny 3DSSD and of the tiny
PointRCNN and one single-stage train step record a span at each layer
boundary, nested as the layers are, one root a call; without a profiler a
span is one shared no-op; the exported tiny flagship holds no profiler node
and the same nodes as without spans; `span_device_times` sums the device
work linked to each span, a backward's other thread included."""

from __future__ import annotations

import contextlib
import sys
from types import SimpleNamespace
from unittest import mock

import pytest
import torch
from test_torch_export import REPO, TINY, _pipeline, _scans

from ssd3d_torch.bin.export import export_infer
from ssd3d_torch.entry import synthetic_scenes
from ssd3d_torch.models.api import rcnn_chunk
from ssd3d_torch.utils import profiling

PRCNN_TINY = REPO / "configs" / "kitti" / "pointrcnn" / "pointrcnn_tiny_stage2.yaml"
SA = ["ssd3d.sa.sample", "ssd3d.sa.group", "ssd3d.sa.mlp"]
CPU = torch.autograd.DeviceType.CPU


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [e for e in prof.events() if e.device_type == CPU and e.name.startswith("ssd3d.")]


def _parent(e):
    """The span around event e (None for a root)."""
    p = e.cpu_parent
    while p is not None and not p.name.startswith("ssd3d."):
        p = p.cpu_parent
    return p


def _children(spans, parent) -> list[str]:
    return [e.name for e in sorted(spans, key=lambda e: e.time_range.start)
            if _parent(e) is parent]


def _one_root(spans, name):
    roots = [e for e in spans if _parent(e) is None]
    assert [r.name for r in roots] == [name]
    root = roots[0]
    for e in spans:  # every span lies inside its root
        assert root.time_range.start <= e.time_range.start <= e.time_range.end \
            <= root.time_range.end, e.name
    return root


def _holds_layers(spans, parent, backbone):
    """The backbone's layer spans in order under `parent`, each SA layer's
    sampling, grouping and MLP spans under it."""
    layers = [e for e in spans if e.name.startswith("ssd3d.backbone.") and _parent(e) is parent]
    assert [e.name for e in sorted(layers, key=lambda e: e.time_range.start)] == \
        backbone.span_names
    for e, (_, layer_type, spec) in zip(sorted(layers, key=lambda e: e.time_range.start),
                                        backbone.layers):
        want = []
        if layer_type == "SA_Layer":
            want = SA if spec[2] else SA[:1]  # a radius-less layer only samples
        assert [n for n in _children(spans, e) if n.startswith("ssd3d.sa.")] == want, e.name


@pytest.fixture(scope="module")
def tiny():
    cfg, pipe = _pipeline(TINY)
    return pipe, cfg.MODEL.POINTS_NUM_FOR_TRAINING


def test_span_is_one_shared_no_op_without_a_profiler():
    assert not torch.autograd.profiler._is_profiler_enabled
    first, second = profiling.span("ssd3d.a"), profiling.span("ssd3d.b")
    assert first is second
    with first as entered:
        assert entered is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        live = profiling.span("ssd3d.a")
        assert isinstance(live, torch.profiler.record_function) and live.name == "ssd3d.a"


def test_tiny_3dssd_infer_records_its_spans(tiny):
    pipe, n = tiny
    points = _scans(2, n)
    spans = _profiled(lambda: pipe.infer(points))
    root = _one_root(spans, "ssd3d.infer")
    assert _children(spans, root) == ["ssd3d.backbone", "ssd3d.head", "ssd3d.decode"]
    by_name = {e.name: e for e in spans if _parent(e) is root}
    _holds_layers(spans, by_name["ssd3d.backbone"], pipe.model.backbone)
    assert _children(spans, by_name["ssd3d.decode"]) == ["ssd3d.nms"]
    assert _children(spans, by_name["ssd3d.head"]) == []


def test_tiny_pointrcnn_infer_records_its_spans():
    cfg, pipe = _pipeline(PRCNN_TINY, nms_pre_topk=512)
    points = _scans(2, cfg.MODEL.POINTS_NUM_FOR_TRAINING)
    # the proposals in several RCNN passes, one span each
    proposals = cfg.MODEL.FIRST_STAGE.MAX_OUTPUT_NUM
    chunks = proposals // rcnn_chunk(proposals, proposals // 3)
    assert chunks > 1
    with mock.patch.object(pipe.inference, "chunk_limit", proposals // 3):
        spans = _profiled(lambda: pipe.infer(points))
    root = _one_root(spans, "ssd3d.infer")
    assert _children(spans, root) == (["ssd3d.rpn", "ssd3d.proposals"] + ["ssd3d.rcnn"] * chunks
                                      + ["ssd3d.decode"])
    top = [e for e in spans if _parent(e) is root]
    rpn = top[0]
    _holds_layers(spans, rpn, pipe.model.rpn_backbone)
    assert _children(spans, top[1]) == ["ssd3d.nms"]
    assert _children(spans, top[-1]) == ["ssd3d.nms"]
    for rcnn in top[2:-1]:
        assert _children(spans, rcnn)[0] == "ssd3d.rcnn.pool"
        _holds_layers(spans, rcnn, pipe.model.rcnn_backbone)


def test_single_stage_train_step_records_its_spans():
    cfg, pipe = _pipeline(TINY)
    graph = pipe.graph
    assert graph.histograms  # the grad and param norms run too
    state = graph.init_state()
    data = synthetic_scenes(2, cfg.MODEL.POINTS_NUM_FOR_TRAINING, seed=3)
    batch = {k: torch.from_numpy(v) for k, v in data.items()}
    spans = _profiled(lambda: graph.train_step(state, batch))
    root = _one_root(spans, "ssd3d.train.step")
    assert _children(spans, root) == [
        "ssd3d.train.forward", "ssd3d.train.targets", "ssd3d.train.loss",
        "ssd3d.train.backward", "ssd3d.train.metrics", "ssd3d.train.update",
        "ssd3d.train.metrics"]
    forward = next(e for e in spans if e.name == "ssd3d.train.forward")
    assert _children(spans, forward) == ["ssd3d.backbone", "ssd3d.head"]
    _holds_layers(spans, next(e for e in spans if e.name == "ssd3d.backbone"),
                  pipe.model.backbone)
    for name in ("ssd3d.train.targets", "ssd3d.train.loss", "ssd3d.train.backward",
                 "ssd3d.train.update"):
        assert _children(spans, next(e for e in spans if e.name == name)) == [], name
    assert state.step == 1


def _without_spans() -> tuple[contextlib.ExitStack, list[str]]:
    """Every module's `span` made the no-op, whatever the profiler's state;
    -> the patches and the modules patched."""
    stack, patched, span = contextlib.ExitStack(), [], profiling.span
    for name, mod in list(sys.modules.items()):
        if name.startswith("ssd3d_torch.") and getattr(mod, "span", None) is span:
            stack.enter_context(mock.patch.object(mod, "span",
                                                  lambda name: contextlib.nullcontext()))
            patched.append(name)
    return stack, patched


def test_export_holds_no_profiler_node_and_the_nodes_without_spans(tiny):
    pipe, n = tiny

    def targets(exported):
        return [str(node.target) for node in exported.graph.nodes]

    stack, patched = _without_spans()
    with stack:
        bare = targets(export_infer(pipe, 2, n))
    assert {"ssd3d_torch.models.api", "ssd3d_torch.models.backbone", "ssd3d_torch.nn.modules",
            "ssd3d_torch.ops.nms"} <= set(patched)
    spanned = targets(export_infer(pipe, 2, n))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiled = targets(export_infer(pipe, 2, n))
    assert spanned == bare and profiled == bare
    assert not [t for t in bare if "profiler" in t or "record_function" in t]


def _event(name, thread, start, end, kernels=(), children=()):
    e = SimpleNamespace(name=name, thread=thread, device_type=CPU, cpu_parent=None,
                        time_range=SimpleNamespace(start=start, end=end),
                        kernels=[SimpleNamespace(name=k, duration=d) for k, d in kernels],
                        cpu_children=list(children))
    for c in children:
        c.cpu_parent = e
    return e


def test_span_device_times_on_made_up_events():
    # the main thread: a step span over 0-100 us holding a backward span over
    # 40-80 us; an op under the step launches a kernel of 5 us and a copy of 2 us.
    # The autograd thread: an op at 50 us (kernels of 3 and 4 us) inside the
    # backward's range, one at 90 us (1 us) after it, one at 120 us outside both.
    op = _event("aten::add", 1, 10, 20, [("add_kernel", 5.0), ("Memcpy DtoD", 2.0)])
    inner = _event("aten::mul", 2, 51, 52, [("mul_kernel", 3.0)])
    grad = _event("MulBackward0", 2, 50, 60, [("sum_kernel", 4.0)], [inner])
    late = _event("AddBackward0", 2, 90, 91, [("add_kernel", 1.0)])
    outside = _event("aten::copy_", 2, 120, 121, [("copy_kernel", 9.0)])
    backward = _event("ssd3d.train.backward", 1, 40, 80)
    step = _event("ssd3d.train.step", 1, 0, 100, children=[op, backward])
    device = SimpleNamespace(name="ssd3d.train.step", device_type=torch.autograd.DeviceType.CUDA)
    times = profiling.span_device_times(
        [step, op, backward, grad, inner, late, outside, device])
    assert times == {"ssd3d.train.step": (15.0, 4), "ssd3d.train.backward": (7.0, 2)}


def test_span_device_times_of_a_cpu_profile(tiny):
    pipe, n = tiny
    points = _scans(1, n)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pipe.infer(points)
        pipe.infer(points)
    times = profiling.span_device_times(prof.events())
    names = {"ssd3d.infer", "ssd3d.backbone", "ssd3d.head", "ssd3d.decode", "ssd3d.nms"}
    assert names | set(SA) | set(pipe.model.backbone.span_names) == set(times)
    assert set(times.values()) == {(0.0, 0)}  # no card: nothing linked
