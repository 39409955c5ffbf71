"""PointRCNN inference: the port's ops, modules and whole shrunk slice against
the JAX package.

Inputs and weights are made with numpy from a seed and handed to both
packages; the JAX side runs on the CPU, jitted. The shrunk configuration is
the in-repo `configs/kitti/pointrcnn/pointrcnn_test.yaml` with narrow widths,
1,024-point scans and 32 proposals, at batch 2, so that the RCNN's SA layers
see batch x proposals = 64 clouds and take the fused route in the port (the
JAX package fuses only on a TPU; its CPU route is unfused).
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd3d.config import load_cfg as jax_load_cfg
from ssd3d.core import box_coders as jcoders
from ssd3d.core import geometry as jgeometry
from ssd3d.models.api import build_pipeline as jax_build_pipeline
from ssd3d.models.two_stage import build_two_stage as jax_build_two_stage
from ssd3d.ops import grouping as jgrouping
from ssd3d.ops import nms as jnms
from ssd3d.ops import topk as jtopk
from ssd3d_torch.core import box_coders, geometry
from ssd3d_torch.models.api import build_pipeline, rcnn_chunk
from ssd3d_torch.models.two_stage import build_two_stage
from ssd3d_torch.ops import grouping, nms, topk
from ssd3d_torch.utils.convert import flax_to_state_dict

REPO = Path(__file__).resolve().parents[1]
# f32: the two frameworks sum matmuls in other orders (~1e-7 relative per
# layer over ~20 layers); held within 1e-4 of the compared tensor's largest
# |value|, the bound chip_smoke.py uses card against CPU
F32_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=F32_TOL, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * max(scale, 1e-6), (what, err, scale)


def _boxes(rng, n):
    ctr = rng.uniform(-20, 20, (n, 3))
    ctr[:, 1] = rng.uniform(0.5, 2.5, n)
    ctr[:, 2] = rng.uniform(5, 40, n)
    size = rng.uniform(0.5, 5.0, (n, 3))
    ry = rng.uniform(-np.pi, np.pi, (n, 1))
    return np.concatenate([ctr, size, ry], 1).astype(np.float32)


# ------------------------------------------------------ codecs and geometry

def test_bin_anchor_decode_and_anchors_match_jax():
    rng = np.random.RandomState(0)
    b, n, na = 2, 300, 12
    for half_range, bins in ((3.0, 12), (1.5, 6)):
        jcoder = jcoders.BoxCoder("Bin-Anchor", na, half_range=half_range, num_bins=bins)
        coder = box_coders.BoxCoder("Bin-Anchor", na, half_range=half_range, num_bins=bins)
        assert coder.reg_channels == jcoder.reg_channels == 4 * bins + 4
        pts = rng.uniform(-20, 20, (b, n, 3)).astype(np.float32)
        anchors = jcoders.AnchorGenerator("KITTI", ("Car", "Cyclist"), "Bin-Anchor")(
            jnp.asarray(pts))
        got_anchors = box_coders.AnchorGenerator("KITTI", ("Car", "Cyclist"), "Bin-Anchor")(_t(pts))
        np.testing.assert_allclose(got_anchors.numpy(), np.asarray(anchors), rtol=1e-6, atol=1e-6)
        off = rng.randn(b, n, 2, coder.reg_channels).astype(np.float32)
        a_cls = rng.randn(b, n, 2, na).astype(np.float32)
        a_res = (rng.rand(b, n, 2, na) - 0.5).astype(np.float32)
        want = jcoder.decode(jnp.asarray(pts), jnp.asarray(off), jnp.asarray(a_cls),
                             jnp.asarray(a_res), anchors)
        got = coder.decode(_t(pts), _t(off), _t(a_cls), _t(a_res), got_anchors)
        assert got.shape == (b, n, 2, 7)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)
    # Bin-Anchor encoding: GT boxes against the mean-size anchors (stage 1)
    # and against proposals (stage 2), bins equal, residuals within 1e-6
    for half_range, bins in ((3.0, 12), (1.5, 6)):
        jcoder = jcoders.BoxCoder("Bin-Anchor", na, half_range=half_range, num_bins=bins)
        coder = box_coders.BoxCoder("Bin-Anchor", na, half_range=half_range, num_bins=bins)
        gt = _boxes(rng, b * n * 2).reshape(b, n, 2, 7)
        gt[..., 0:3] = np.asarray(anchors)[..., 0:3] + rng.uniform(-4, 4, (b, n, 2, 3))
        want = jcoder.encode(jnp.asarray(pts), jnp.asarray(gt), anchors)
        got = coder.encode(_t(pts), _t(gt), got_anchors)
        assert got[0].shape == (b, n, 2, 8)
        bins_at = [0, 2]  # x bin, z bin
        np.testing.assert_array_equal(got[0][..., bins_at].numpy(), np.asarray(want[0])[..., bins_at])
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-6, atol=1e-6)
        assert len(np.unique(np.asarray(want[0])[..., 0])) == bins  # every x bin taken


def test_bottom_to_center_and_canonical_points_match_jax():
    rng = np.random.RandomState(1)
    boxes = _boxes(rng, 40)
    pts = rng.randn(40, 50, 3).astype(np.float32) * 5
    np.testing.assert_allclose(geometry.boxes_bottom_to_center(_t(boxes)).numpy(),
                               np.asarray(jgeometry.boxes_bottom_to_center(jnp.asarray(boxes))),
                               rtol=1e-6)
    np.testing.assert_allclose(
        geometry.canonicalize_points(_t(pts), _t(boxes)).numpy(),
        np.asarray(jgeometry.canonicalize_points(jnp.asarray(pts), jnp.asarray(boxes))),
        rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------- top-k and NMS

@pytest.mark.parametrize("n,k", [(4096, 2048), (300, 64), (50, 64)])
def test_top_k_set_matches_jax_with_ties(n, k):
    rng = np.random.RandomState(n)
    # few distinct values: many ties at the threshold, broken by the lower index
    scores = rng.choice(np.linspace(0.0, 1.0, 17), size=(3, n)).astype(np.float32)
    scores[0, :5] = -0.0
    want_i, want_v = jtopk.top_k_set(jnp.asarray(scores), k)
    got_i, got_v = topk.top_k_set(_t(scores), k)
    # JAX's valid is [1, k], broadcast over the rows
    np.testing.assert_array_equal(got_v.numpy(), np.broadcast_to(want_v, got_v.shape))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    if n >= k:
        _, ref = jax.lax.top_k(jnp.asarray(scores), k)
        np.testing.assert_array_equal(got_i.numpy(), np.sort(np.asarray(ref), axis=1))


@pytest.mark.parametrize("pre_topk", [0, 200])
def test_class_unaware_nms_matches_jax(pre_topk):
    rng = np.random.RandomState(3)
    b, n = 2, 600
    boxes = np.stack([_boxes(rng, n * 2).reshape(n, 2, 7) for _ in range(b)])
    boxes[..., 0] = rng.uniform(0, 15, (b, n, 2))
    boxes[..., 2] = rng.uniform(0, 15, (b, n, 2))
    scores = rng.choice(np.linspace(0.05, 0.95, 40), size=(b, n, 2)).astype(np.float32)
    want = jnms.class_unaware_nms(jnp.asarray(boxes), jnp.asarray(scores), 50, 0.3,
                                  pre_topk=pre_topk)
    got = nms.class_unaware_nms(_t(boxes), _t(scores), 50, 0.3, pre_topk=pre_topk)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert 0 < int(got[2].sum()) <= 100


def test_query_boxes_3d_points_matches_jax_exactly():
    rng = np.random.RandomState(4)
    b, n, m = 2, 3000, 30
    boxes = np.stack([_boxes(rng, m) for _ in range(b)])
    boxes[..., 3:6] += 3.0
    boxes[:, -2:, 0] += 1000.0  # far from every point: empty
    xyz = np.concatenate([  # points around and inside the boxes
        (boxes[:, :, None, 0:3] + rng.randn(b, m, n // m, 3) * 2.0)[:, :-2].reshape(b, -1, 3),
        rng.uniform(-20, 40, (b, 200, 3))], 1).astype(np.float32)
    for ns in (16, 128):
        want_i, want_c = jgrouping.query_boxes_3d_points(jnp.asarray(xyz), jnp.asarray(boxes), ns)
        got_i, got_c = grouping.query_boxes_3d_points(_t(xyz), _t(boxes), ns)
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        assert (got_c.numpy() > 0).mean() > 0.5 and (got_c.numpy() == 0).any()


# ---------------------------------------------------- the shrunk PointRCNN

def _shrunk_cfg():
    """pointrcnn_test.yaml with narrow widths, 1,024 points and 32 proposals."""
    cfg = jax_load_cfg(str(REPO / "configs/kitti/pointrcnn/pointrcnn_test.yaml"))
    cfg.MODEL.POINTS_NUM_FOR_TRAINING = 1024
    arch = cfg.MODEL.NETWORK.FIRST_STAGE.ARCHITECTURE
    for layer, npt in zip(arch[:4], [256, 64, 16, 8]):
        layer[8] = [npt]
        layer[4] = [[8, 8], [8, 8]]
        layer[3] = [4, 8]
    for layer in arch[4:]:  # FP layers
        layer[4] = [16, 16]
    arch2 = cfg.MODEL.NETWORK.SECOND_STAGE.ARCHITECTURE
    arch2[0][8], arch2[0][3], arch2[0][4] = [32], [8], [[8, 8]]
    arch2[1][8], arch2[1][3], arch2[1][4] = [8], [8], [[8, 16]]
    arch2[2][4] = [16, 32]
    cfg.MODEL.NETWORK.SECOND_STAGE.HEAD = [[[0], [4], "conv1d", [16], True, "Det", "rcnn_head"]]
    pooler = cfg.MODEL.NETWORK.FIRST_STAGE.POINTS_POOLER
    pooler[2], pooler[3] = [8], 64
    cfg.MODEL.FIRST_STAGE.MAX_OUTPUT_NUM = 32
    return cfg


def _scans(rng, bs=2, n=1024):
    """Uniform clutter with two dense car-sized clusters per scan."""
    pts = (rng.uniform(-1, 1, (bs, n, 4)) * np.array([15, 1.5, 10, 1])).astype(np.float32)
    pts[..., 2] += 14
    for g, (x, z) in enumerate([(2.0, 10.0), (-6.0, 18.0)]):
        sel = slice(g * 150, (g + 1) * 150)
        pts[:, sel, 0] = x + rng.uniform(-1.5, 1.5, (bs, 150))
        pts[:, sel, 1] = 1.5 - rng.uniform(0, 1.5, (bs, 150))
        pts[:, sel, 2] = z + rng.uniform(-0.7, 0.7, (bs, 150))
    return pts


def _fill(shapes, seed):
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            lim = np.sqrt(6.0 / (s.shape[0] + s.shape[1]))
            return rng.uniform(-lim, lim, s.shape)
        if name in ("scale", "var"):
            return rng.uniform(0.8, 1.2, s.shape)
        return rng.uniform(-0.1, 0.1, s.shape)

    return jax.tree_util.tree_map_with_path(lambda p, s: leaf(p, s).astype(np.float32), shapes)


PRE_TOPK = 512  # below the 1,024 candidates: the prefilter runs


@pytest.fixture(scope="module")
def slice_run():
    """(cfg, flax variables, scans, JAX detections, the port's pipeline)."""
    cfg = _shrunk_cfg()
    points = _scans(np.random.RandomState(0))
    jmodel, rpn_spec, _ = jax_build_two_stage(cfg, nms_pre_topk=PRE_TOPK)
    shapes = jax.eval_shape(lambda p: jmodel.init(jax.random.PRNGKey(0), p, False, 0.9,
                                                  rpn_spec=rpn_spec), jnp.asarray(points))
    variables = _fill(shapes, 5)
    want = jax.jit(jax_build_pipeline(cfg, nms_pre_topk=PRE_TOPK).infer)(
        variables, jnp.asarray(points))
    pipe = build_pipeline(cfg, nms_pre_topk=PRE_TOPK, device="cpu")
    pipe.model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return cfg, variables, points, {k: np.asarray(v) for k, v in want.items()}, pipe


def test_two_stage_flax_tree_loads_strictly(slice_run):
    cfg, variables, _, _, _ = slice_run
    model, _, _ = build_two_stage(cfg, device="cpu")
    sd = flax_to_state_dict(variables)
    assert len(sd) == len(jax.tree_util.tree_leaves(variables))
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert missing == [] and unexpected == []
    names = {k.split(".")[0] for k in sd}
    assert names == {"rpn_backbone", "rpn_head", "roi_pool", "rcnn_backbone", "rcnn_head"}
    assert "roi_pool.align.conv0.conv.kernel" in sd


def test_shrunk_pointrcnn_matches_jax(slice_run):
    """Proposals, final boxes and scores within 1e-4 of the largest |value|;
    keep sets, classes and indices equal."""
    _, _, points, want, pipe = slice_run
    from ssd3d_torch.ops import sa_fused

    calls = []
    orig = sa_fused.sa_fused_multi
    sa_fused.sa_fused_multi = lambda *a: calls.append(a[0].shape) or orig(*a)
    try:
        got = {k: v.numpy() for k, v in pipe.infer(_t(points)).items()}
    finally:
        sa_fused.sa_fused_multi = orig
    assert [tuple(s) for s in calls] == [(64, 64, 27), (64, 32, 11)]  # the RCNN's SA1, SA2
    assert set(got) == set(want)
    for key in ("proposals_valid", "valid", "classes", "index"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    _close(got["proposals"], want["proposals"], what="proposals")
    _close(got["boxes"], want["boxes"], what="boxes")
    _close(got["scores"], want["scores"], what="scores")
    assert got["proposals_valid"].sum() > 8 and got["valid"].sum() > 0


def test_chunked_rcnn_matches_unchunked(slice_run):
    """RCNN_INFER_CHUNK 8: four passes of 2 x 8 proposals, each below the
    fused route's 64 clouds, against the one fused pass of 2 x 32."""
    cfg, variables, points, _, pipe = slice_run
    assert rcnn_chunk(32, 8) == 8 and rcnn_chunk(100, 256) == 100 and rcnn_chunk(30, 0) == 30
    chunked_cfg = cfg.clone()
    chunked_cfg.TEST.RCNN_INFER_CHUNK = 8
    chunked = build_pipeline(chunked_cfg, nms_pre_topk=PRE_TOPK, device="cpu")
    chunked.model.load_state_dict(flax_to_state_dict(variables), strict=True)
    got = chunked.infer(_t(points))
    want = pipe.infer(_t(points))
    for key in ("valid", "index", "proposals_valid"):
        assert torch.equal(got[key], want[key]), key
    for key in ("boxes", "scores", "proposals"):
        _close(got[key].numpy(), want[key].numpy(), what=key)


def test_only_first_stage_returns_the_proposals(slice_run):
    cfg, variables, points, want, _ = slice_run
    first = cfg.clone()
    first.MODEL.ONLY_FIRST_STAGE = True
    pipe = build_pipeline(first, nms_pre_topk=PRE_TOPK, device="cpu")
    pipe.model.load_state_dict(flax_to_state_dict(variables), strict=True)
    got = pipe.infer(_t(points))
    assert set(got) == {"boxes", "scores", "classes", "valid"}
    np.testing.assert_array_equal(got["valid"].numpy(), want["proposals_valid"])
    _close(got["boxes"].numpy(), want["proposals"])


def test_points_pool_is_not_ported_yet():
    """STD's PointsPool is ported now (tests/test_torch_std.py holds it to
    the JAX package): its pooler row builds, and an unknown pooler raises."""
    from ssd3d_torch.models.two_stage import PointsPool

    cfg = _shrunk_cfg()
    cfg.MODEL.NETWORK.FIRST_STAGE.POINTS_POOLER[0] = "PointsPool"
    model, _, _ = build_two_stage(cfg, device="cpu")
    assert isinstance(model.roi_pool, PointsPool)
    cfg.MODEL.NETWORK.FIRST_STAGE.POINTS_POOLER[0] = "VoxelPool"
    with pytest.raises(ValueError, match="unknown RoI pooler"):
        build_two_stage(cfg, device="cpu")
