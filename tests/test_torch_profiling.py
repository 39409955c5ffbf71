"""The port's profiling hooks (`ssd3d_torch/utils/profiling.py`): a crafted
Chrome trace summed by name and by category (device events first, the CPU
ops of a CPU-only trace otherwise) and a CPU `trace` of the tiny flagship
(the spans: `tests/test_torch_spans.py`)."""

from __future__ import annotations

import gzip
import json
import os
import time
from pathlib import Path

import pytest
import torch

from ssd3d_torch.config import load_cfg
from ssd3d_torch.entry import init_weights, synthetic_scenes
from ssd3d_torch.models.api import build_pipeline
from ssd3d_torch.utils import profiling

TINY = Path(__file__).resolve().parents[1] / "configs" / "kitti" / "3dssd" / "3dssd_tiny.yaml"


def _write(path, events, gz=True):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    opener = gzip.open if gz else open
    with opener(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


def _x(name, cat, dur):
    return {"ph": "X", "name": name, "cat": cat, "dur": dur, "ts": 0}


def test_summarize_sums_device_events_by_name_and_category(tmp_path):
    events = [_x("dfps_cluster_kernel", "kernel", 2500.0),
              _x("dfps_cluster_kernel", "kernel", 500.0),
              _x("gather_rows_kernel", "kernel", 1000.0), _x("Memcpy HtoD", "gpu_memcpy", 250.0),
              _x("Memset", "gpu_memset", 50.0), _x("aten::mm", "cpu_op", 99999.0),
              _x("cudaLaunchKernel", "cuda_runtime", 7.0),
              {"ph": "i", "name": "marker", "cat": "kernel"}]  # no duration: not summed
    _write(str(tmp_path / "old" / "a.pt.trace.json.gz"), [_x("old", "kernel", 1.0)])
    time.sleep(0.01)
    _write(str(tmp_path / "new" / "b.pt.trace.json"), events, gz=False)
    assert profiling.summarize_trace(str(tmp_path)) == [
        ("dfps_cluster_kernel", 3.0), ("gather_rows_kernel", 1.0), ("Memcpy HtoD", 0.25),
        ("Memset", 0.05)]
    assert profiling.summarize_trace(str(tmp_path), top=2) == [("dfps_cluster_kernel", 3.0),
                                                               ("gather_rows_kernel", 1.0)]
    assert profiling.summarize_trace(str(tmp_path), by_category=True) == [
        ("kernel", 4.0), ("gpu_memcpy", 0.25), ("gpu_memset", 0.05)]


def test_summarize_a_cpu_trace_sums_its_ops(tmp_path):
    _write(str(tmp_path / "t.pt.trace.json.gz"),
           [_x("aten::matmul", "cpu_op", 3000.0), _x("aten::mm", "cpu_op", 2900.0),
            _x("aten::matmul", "cpu_op", 1000.0), _x("python", "python_function", 5.0)])
    assert profiling.summarize_trace(str(tmp_path)) == [("aten::matmul", 4.0), ("aten::mm", 2.9)]
    assert profiling.summarize_trace(str(tmp_path), by_category=True) == [("cpu_op", 6.9)]
    with pytest.raises(FileNotFoundError):
        profiling.summarize_trace(str(tmp_path / "empty"))


def test_trace_of_the_tiny_flagship_on_the_cpu(tmp_path):
    cfg = load_cfg(str(TINY))
    pipe = build_pipeline(cfg, device="cpu")
    init_weights(pipe.model, 0)
    points = torch.from_numpy(synthetic_scenes(1, cfg.MODEL.POINTS_NUM_FOR_TRAINING)["points"])
    with profiling.trace(str(tmp_path)) as prof:
        det = pipe.infer(points)
    assert det["boxes"].shape == (1, 100, 7)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json.gz")
    summary = dict(profiling.summarize_trace(str(tmp_path), top=1000))
    # the kernels' custom ops run their plain versions on the CPU
    for op in ("ssd3d::fps", "ssd3d::ffps", "ssd3d::ball_query", "ssd3d::gather_rows"):
        assert summary.get(op, 0.0) > 0.0, op
    assert list(summary.values()) == sorted(summary.values(), reverse=True)
    # the same ops in the profiler's own tables
    names = {e.key for e in prof.key_averages()}
    assert {"ssd3d::fps", "ssd3d::ball_query"} <= names

