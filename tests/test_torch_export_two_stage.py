"""Serving export of the tiny PointRCNN (`configs/kitti/pointrcnn/
pointrcnn_tiny_stage2.yaml`): its artifact at a fixed batch round-trips
through `torch.export.save` / `load` and equals live `Pipeline.infer`
exactly, proposals included, and its graph holds each NMS's keep sweep as
one `ssd3d.nms_keep` node (`tests/test_torch_export.py` holds the
single-stage configs)."""

from __future__ import annotations

from collections import Counter
from unittest import mock

import pytest
from test_torch_export import REPO, _assert_equal, _custom_ops, _pipeline, _round_trip, _scans

from ssd3d_torch.bin.export import export_infer
from ssd3d_torch.ops import nms

PRCNN_TINY = REPO / "configs" / "kitti" / "pointrcnn" / "pointrcnn_tiny_stage2.yaml"
# the proposal NMS's prefilter of the tiny PointRCNN (below its 2,048
# candidates, as the two-stage parity tests set it): a sweep of 512
# candidates, which a host-driven loop would write into the graph step by step
PRCNN_PRE_TOPK = 512


@pytest.fixture(scope="module")
def prcnn():
    cfg, pipe = _pipeline(PRCNN_TINY, nms_pre_topk=PRCNN_PRE_TOPK)
    n = cfg.MODEL.POINTS_NUM_FOR_TRAINING
    return pipe, n, export_infer(pipe, 2, n)


def test_pointrcnn_tiny_artifact_equals_live(prcnn, tmp_path):
    pipe, n, exported = prcnn
    assert {"three_nn", "fps", "ball_query", "gather_rows", "nms_keep"} <= _custom_ops(exported)
    served = _round_trip(exported, tmp_path / "prcnn.pt2")
    points = _scans(2, n, seed=4)
    got, want = served(points), pipe.infer(points)
    _assert_equal(got, want)
    assert {"proposals", "proposals_valid"} <= set(got)


def test_pointrcnn_graph_holds_one_keep_node_per_nms(prcnn):
    """One `ssd3d.nms_keep` node for each NMS a live forward calls (the
    proposal NMS and the final NMS), and no operation written once a sweep
    step: no node target occurs as often as the sweep has candidates."""
    pipe, n, exported = prcnn
    calls = []
    real = nms.nms_keep

    def counting(suppress):
        calls.append(tuple(suppress.shape))
        return real(suppress)

    with mock.patch.object(nms, "nms_keep", counting):
        pipe.infer(_scans(2, n, seed=4))
    assert len(calls) == 2 and calls[0] == (2, PRCNN_PRE_TOPK, PRCNN_PRE_TOPK)
    targets = Counter(str(node.target) for node in exported.graph.nodes
                      if node.op == "call_function")
    assert targets["ssd3d.nms_keep.default"] == len(calls)
    assert max(targets.values()) < PRCNN_PRE_TOPK, targets.most_common(3)
    # 2,092 nodes in all; the sweep's 512 steps written out took ~5 each
    assert len(exported.graph.nodes) < 3000
