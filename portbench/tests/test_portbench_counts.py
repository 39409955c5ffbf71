"""The yardstick's counts, checked by hand at one shape, and shown to depend
on the configuration's shapes alone; the per-layer readers on a made-up
trace."""

from __future__ import annotations

import copy
import importlib
from types import SimpleNamespace

import pytest

from portbench import harness, peaks, rooflines, trace

SA_ROW = [[0], [0], [0.2, 0.4], [16, 32], [[8, 16], [8, 32]], True, [-1], ["D-FPS"], [64],
          -1, False, "SA_Layer", "layer1", True, -1, 24]


def tiny_config(two_stage: bool = False) -> dict:
    head = [[[1], [1], "conv1d", [32], True, "Det", ""]]
    stage = {"REGRESSION_METHOD": {"TYPE": "Dist-Anchor-free", "HALF_BIN_SEARCH_RANGE": 3.0,
                                   "BIN_CLASS_NUM": 12},
             "CLS_ACTIVATION": "Sigmoid", "MAX_OUTPUT_NUM": 10}
    return {"MODEL": {"TYPE": "SingleStage", "POINTS_NUM_FOR_TRAINING": 256, "ANGLE_CLS_NUM": 12,
                      "FIRST_STAGE": stage,
                      "NETWORK": {"AGGREGATION_SA_FEATURE": True,
                                  "FIRST_STAGE": {"ARCHITECTURE": [SA_ROW], "HEAD": head}}},
            "DATASET": {"KITTI": {"CLS_LIST": ["Car"]}}, "TPU": {"COMPUTE_DTYPE": "float32"}}


def test_flops_by_hand():
    # SA: 64 centres; ring 1: 16 samples through (1 + 3) -> 8 -> 16; ring 2: 32 samples
    # through 4 -> 8 -> 32; aggregation 48 -> 24. Head over the 64 points: trunk 24 -> 32,
    # two 128-wide bases, cls 128 -> 1, reg 128 -> 6 + 2 * 12.
    sa = 64 * (16 * (4 * 8 + 8 * 16) + 32 * (4 * 8 + 8 * 32)) + 64 * 48 * 24
    head = 64 * (24 * 32 + 2 * 32 * 128 + 128 * 1 + 128 * 30)
    assert rooflines.flops(tiny_config(), 2) == 2.0 * 2 * (sa + head)
    assert rooflines.flops(tiny_config(), 2, train=True) == 3 * 2.0 * 2 * (sa + head)


def test_fps_bound_by_hand():
    # 2 clouds x 256 points x 64 picks x 10 operations at 67 TFLOP/s against
    # 2 x (256 x 12 + 64 x 4) bytes at 3.35 TB/s
    ops_s = 10 * 2 * 256 * 64 / peaks.F32_FLOP_PER_S
    bytes_s = 2 * (256 * 12 + 64 * 4) / peaks.HBM_BYTES_PER_S
    assert rooflines.shapes(tiny_config(), 2)["dfps"] == [(2, 256, 64)]
    assert rooflines.fps_bound_s(2, 256, 64) == max(ops_s, bytes_s)


def test_sa_fused_bound_by_hand():
    macs = 32 * (16 * (4 * 8 + 8 * 16))
    b = 4 * (10 * (512 * 4 + 32 * 16 + 32 * 3 + 32 + 32 * 16) + (4 * 8 + 8 * 16) + 3 * 24)
    want = max(2.0 * 10 * macs / peaks.F32_MATMUL_FLOP_PER_S, b / peaks.HBM_BYTES_PER_S)
    assert rooflines.sa_fused_bound_s(10, 512, 32, 1, [16], [[8, 16]], None) == want


@pytest.mark.parametrize("name", ["3dssd_kitti_car", "pointrcnn_kitti_car"])
def test_counts_read_no_route_and_no_compile_flag(name, monkeypatch):
    cfg = harness.load_config(name)["cfg"]
    before = (rooflines.flops(cfg, 8), rooflines.shapes(cfg, 8))
    sampling = importlib.import_module("ssd3d_torch.ops.sampling")
    build = importlib.import_module("ssd3d_torch.ops._build")
    monkeypatch.setattr(sampling, "fps_route", lambda b, n: "block")
    monkeypatch.setattr(build, "NVCC_FLAGS", ("-O0",))
    assert (rooflines.flops(cfg, 8), rooflines.shapes(cfg, 8)) == before
    assert rooflines.flops(copy.deepcopy(cfg), 16) == 2 * before[0]


def test_readers_on_a_made_up_trace():
    # two requests over 1 ms: kernels 0-200 us and 300-500 us (an eager add and
    # the fps op's kernel) and a memcpy 450-600 us overlapping the second
    kernels = [(0.0, 200.0, "void at::native::vectorized_elementwise_kernel<add>"),
               (300.0, 500.0, "dfps_cluster_kernel")]
    device = kernels + [(450.0, 600.0, "Memcpy HtoD (Pinned -> Device)")]
    tr = {"requests": 2, "window_s": 1e-3, "busy_s": 400e-6, "device": device,
          "kernels": kernels, "merged": [[0.0, 200.0], [300.0, 600.0]],
          "labelled": [[0.0, 200.0], [300.0, 600.0]],
          "host": [(150.0, 350.0, "aten::cat")], "op_us": {"ssd3d::fps": 200.0}}
    assert trace.idle_pct(tr) == pytest.approx(60.0)
    assert trace.eager_ms(tr) == pytest.approx(0.1)
    assert trace.launches(tr) == 1.0
    assert trace.op_roofline_pct(tr, "ssd3d::fps", 50e-6) == pytest.approx(50.0)
    assert trace.op_roofline_pct(tr, "ssd3d::sa_fused", 50e-6) is None
    gaps = trace.breakdown(tr)["idle_gaps"]
    assert gaps == [["aten::cat", pytest.approx(100e-6)]]


def test_roofline_readers_count_their_own_bounds():
    # each kernel's reader works out its bound from the configuration's shapes:
    # two requests' D-FPS bound over 200 us inside ssd3d::fps
    tr = {"requests": 2, "op_us": {"ssd3d::fps": 200.0}}
    run = SimpleNamespace(trace=tr, cfg=tiny_config(), batch=2)
    want = 100.0 * rooflines.fps_bound_s(2, 256, 64) * 2 / 200e-6
    assert harness.read_metric("k1_fps_roofline_pct.infer", run) == pytest.approx(want)
    # a single-stage configuration launches no fused SA kernel: nothing to read
    assert harness.read_metric("k7_sa_fused_roofline_pct.infer", run) is None
