"""Serving export of the tiny PointRCNN (`configs/kitti/pointrcnn/
pointrcnn_tiny_stage2.yaml`): its artifact at a fixed batch round-trips
through `torch.export.save` / `load` and equals live `Pipeline.infer`
exactly, proposals included (`tests/test_torch_export.py` holds the
single-stage configs)."""

from __future__ import annotations

from test_torch_export import REPO, _assert_equal, _custom_ops, _pipeline, _round_trip, _scans

from ssd3d_torch.bin.export import export_infer

PRCNN_TINY = REPO / "configs" / "kitti" / "pointrcnn" / "pointrcnn_tiny_stage2.yaml"
# the proposal NMS's prefilter of the tiny PointRCNN (below its 2,048
# candidates, as the two-stage parity tests set it): 512 steps of the
# greedy sweep, which the trace writes out one by one
PRCNN_PRE_TOPK = 512


def test_pointrcnn_tiny_artifact_equals_live(tmp_path):
    cfg, pipe = _pipeline(PRCNN_TINY, nms_pre_topk=PRCNN_PRE_TOPK)
    n = cfg.MODEL.POINTS_NUM_FOR_TRAINING
    exported = export_infer(pipe, 2, n)
    assert {"three_nn", "fps", "ball_query", "gather_rows"} <= _custom_ops(exported)
    served = _round_trip(exported, tmp_path / "prcnn.pt2")
    points = _scans(2, n, seed=4)
    got, want = served(points), pipe.infer(points)
    _assert_equal(got, want)
    assert {"proposals", "proposals_valid"} <= set(got)
