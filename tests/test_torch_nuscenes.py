"""The port's nuScenes 3DSSD path against the JAX package on the CPU: the
synthetic raw tree and its conversion, the frame casts and sweep
aggregation, the voxel budget (its native and numpy branches), the loader's
batches, the NDS metric, the velocity / attribute heads of the tiny config
on converted weights, their gather after NMS, `attr_velo_loss` and one
train step from a shared state, and the nuScenes mean sizes.

Inputs are made with numpy from seeds (the synthetic tree from its seed);
weights come from a seeded flax variable tree through `flax_to_state_dict`.
The JAX side runs on the CPU, jitted.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd3d import native as jnative
from ssd3d.config import load_cfg as jax_load_cfg
from ssd3d.core import box_coders as jcoders
from ssd3d.data import nuscenes as jnusc
from ssd3d.eval import nuscenes_eval as jeval
from ssd3d.models import build_detector as jax_build_detector
from ssd3d.models.backbone import PointBackbone as JaxPointBackbone
from ssd3d.train import losses as jlosses
from ssd3d.train import schedules as jschedules
from ssd3d.train.train_step import TrainGraph as JaxTrainGraph
from ssd3d_torch import config, native
from ssd3d_torch.core import box_coders
from ssd3d_torch.data import nuscenes
from ssd3d_torch.eval import nuscenes_eval
from ssd3d_torch.eval.nuscenes_predictions import (
    detections_to_nusc_boxes,
    gt_batch_to_nusc_boxes,
)
from ssd3d_torch.models.single_stage import build_detector
from ssd3d_torch.models.two_stage import build_two_stage
from ssd3d_torch.train import losses, schedules
from ssd3d_torch.train.train_step import TrainGraph
from ssd3d_torch.utils import synth_nuscenes
from ssd3d_torch.utils.convert import flax_to_state_dict
from tools import synth_nuscenes as jsynth

import test_torch_train as ttrain
import test_torch_two_stage_train as ttwo

REPO = Path(__file__).resolve().parents[1]
TINY = str(REPO / "configs/nuscenes/3dssd/3dssd_tiny.yaml")
FULL = str(REPO / "configs/nuscenes/3dssd/3dssd.yaml")
TREE = dict(n_scenes=3, samples_per_scene=3, n_points=3000, seed=2)
# f32 heads, card-independent: the port's CPU matmuls and XLA's dot sum in
# another order (tests/test_torch_model.py), each head key within this share
# of its largest |value|
HEAD_RTOL = 1e-4
# the nuScenes metric: the same numpy arithmetic in both packages
METRIC_TOL = 1e-9
# one f32 train step from a shared state: each loss within this share of the
# largest loss; gradients and statistics as tests/test_torch_train.py rules
STEP_LOSS_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _opts(root: Path, pkg: str = "jax") -> list:
    return ["DATASET.NUSCENES.BASE_DIR_PATH", str(root / "raw"),
            "DATASET.NUSCENES.SAVE_NUMPY_PATH", str(root / pkg)]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A synthetic raw tree written by both writers (`raw`, `raw_jax`) and
    converted by both packages (`port`, `jax`): 3 scenes of 3 key frames,
    scene 0 in val."""
    root = tmp_path_factory.mktemp("nusc")
    synth_nuscenes.write_tree(str(root / "raw"), **TREE)
    jsynth.write_tree(str(root / "raw_jax"), **TREE)
    for pkg, convert in (("port", nuscenes.convert_raw_nuscenes),
                         ("jax", jnusc.convert_raw_nuscenes)):
        convert("v1.0-synth", str(root / "raw"), str(root / pkg), nsweeps=4,
                log=lambda *a: None)
    return root


def _files(root: Path) -> list:
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


def assert_same_npz_tree(got: Path, want: Path) -> None:
    """Two converted trees hold the same files, lists and arrays (NaN where
    the other has NaN)."""
    assert _files(got) == _files(want) and _files(want)
    for rel in _files(want):
        if rel.suffix == ".txt":
            assert (got / rel).read_text() == (want / rel).read_text()
            continue
        a, b = np.load(got / rel, allow_pickle=True), np.load(want / rel, allow_pickle=True)
        assert sorted(a.files) == sorted(b.files)
        for key in b.files:
            assert a[key].dtype == b[key].dtype, (rel, key)
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"{rel} {key}")


def test_write_tree_and_converter_give_the_reference_files(tree):
    """The port's scene writer writes the tools writer's bytes, and its
    converter the JAX converter's arrays: casts, sweeps, velocities (NaN
    included) and attributes."""
    raw = _files(tree / "raw")
    assert raw == _files(tree / "raw_jax") and len(raw) > 20
    for rel in raw:
        assert (tree / "raw" / rel).read_bytes() == (tree / "raw_jax" / rel).read_bytes(), rel
    assert_same_npz_tree(tree / "port", tree / "jax")
    sample = np.load(next((tree / "port" / "train").glob("*.npz")), allow_pickle=True)
    assert sample["points"].shape[1] == 4 and int(sample["key_points_num"]) < len(
        sample["points"])
    assert len(sample["boxes_3d"]) > 3 and (sample["attributes"] == -1).any()


def test_casts_and_aggregate_sweeps_match_jax():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-30, 30, (200, 5)).astype(np.float32)
    np.testing.assert_array_equal(nuscenes.cast_points_to_kitti(pts),
                                  jnusc.cast_points_to_kitti(pts))
    boxes = np.concatenate([rng.uniform(-30, 30, (9, 3)), rng.uniform(0.3, 5, (9, 3)),
                            rng.uniform(-np.pi, np.pi, (9, 1))], 1).astype(np.float32)
    np.testing.assert_array_equal(nuscenes.cast_boxes_to_kitti(boxes),
                                  jnusc.cast_boxes_to_kitti(boxes))
    for channels, width in ((4, 4), (5, 5), (5, 4)):
        key = rng.uniform(-30, 30, (300, width)).astype(np.float32)
        key[:, 3] = rng.uniform(0, 255, 300)
        sweeps = []
        for j in range(3):
            quat = rng.normal(size=4)
            q = jnusc.quat_to_rot(quat)
            np.testing.assert_array_equal(nuscenes.quat_to_rot(quat), q)
            s = rng.uniform(-30, 30, (150, width)).astype(np.float32)
            s[:, 3] = rng.uniform(0, 255, 150)
            sweeps.append({"points": s, "rotation": q, "translation": rng.normal(size=3),
                           "timestamp": 10.0 - 0.05 * (j + 1)})
        got, got_n = nuscenes.aggregate_sweeps(key, 10.0, sweeps, channels)
        want, want_n = jnusc.aggregate_sweeps(key, 10.0, sweeps, channels)
        assert got_n == want_n == 300 and got.shape == (750, channels)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pile", [False, True])
def test_voxel_budget_sample_native_and_numpy_match_jax(tree, monkeypatch, pile):
    """The kept set of the port's native voxel budget, of its numpy branch
    and of both of the JAX package's, on an aggregated synthetic scan (and
    with a pile of 900 points in one voxel): one set, so the same draws
    give the same points."""
    cfg = config.load_cfg(TINY)
    data = np.load(next((tree / "jax" / "train").glob("*.npz")), allow_pickle=True)
    points, key_num = data["points"], int(data["key_points_num"])
    if pile:
        heap = np.tile(points[:1], (900, 1))
        points = np.concatenate([heap, points])
        key_num += 900
    args = (points, cfg.DATASET.VOXEL_SIZE, cfg.DATASET.POINT_CLOUD_RANGE,
            cfg.DATASET.MAX_NUMBER_OF_POINT_PER_VOXEL, 2048)
    assert native.load() is not None and jnative.load() is not None
    runs = {}
    for branch in ("native", "numpy"):
        if branch == "numpy":
            monkeypatch.setattr(native, "load", lambda: None)
            monkeypatch.setattr(jnative, "load", lambda: None)
        for pkg, fn in (("port", nuscenes.voxel_budget_sample),
                        ("jax", jnusc.voxel_budget_sample)):
            runs[pkg, branch] = fn(np.random.default_rng(7), *args, priority_num=key_num)
    want = runs["jax", "native"]
    assert want.shape == (2048, 4)
    for k, got in runs.items():
        np.testing.assert_array_equal(got, want, err_msg=str(k))
    if pile:  # the voxel cap leaves at most 100 points of the heap
        assert (want == points[0]).all(-1).sum() <= cfg.DATASET.MAX_NUMBER_OF_POINT_PER_VOXEL


@pytest.mark.parametrize("threads,start_iter", [(0, 0), (2, 1)])
def test_loader_batches_equal_the_reference(tree, threads, start_iter):
    """Batches of the port's NuScenesLoader equal the JAX loader's for the
    same seed, epoch and index: points, boxes, labels, velocities and
    attributes (-1 on the cones and barriers)."""
    got_cfg = config.load_cfg(TINY, _opts(tree))
    want_cfg = jax_load_cfg(TINY, _opts(tree))
    got_loader = nuscenes.NuScenesLoader(got_cfg, "train", seed=4)
    want_loader = jnusc.NuScenesLoader(want_cfg, "train", seed=4)
    assert got_loader.sample_points_shape == want_loader.sample_points_shape == (2048, 4)
    got = list(got_loader.batches(2, epochs=2, num_threads=threads, start_iter=start_iter))
    want = list(want_loader.batches(2, epochs=2, num_threads=threads, start_iter=start_iter))
    assert len(got) == len(want) == 6 - start_iter
    for g, w in zip(got, want):
        assert g["names"] == w["names"]
        for key in nuscenes.NuScenesLoader.BATCH_KEYS:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    assert any((b["gt_attribute"][b["gt_labels"] > 0] == -1).any() for b in want)
    assert all((b["gt_labels"] > 0).sum() > 4 for b in want)


# ------------------------------------------------------------------ metric

def _metric_boxes(seed: int, classes):
    """Per-frame GT and detections: jittered copies of the GTs, misses,
    false positives, NaN-free velocities, attributes -1 on some GTs."""
    rng = np.random.RandomState(seed)
    gts, dets = [], []
    for _ in range(12):
        frame_gt, frame_det = [], []
        for _ in range(rng.randint(2, 7)):
            cls = classes[rng.randint(len(classes))]
            box = nuscenes_eval.NuscBox(
                cls, np.array([rng.uniform(-30, 30), 1.0, rng.uniform(-30, 30)]),
                rng.uniform(0.4, 5.0, 3), float(rng.uniform(-3, 3)), rng.randn(2),
                int(rng.randint(-1, 8)))
            frame_gt.append(box)
            if rng.rand() < 0.8:
                frame_det.append(nuscenes_eval.NuscBox(
                    cls, box.center + rng.randn(3) * [0.8, 0.1, 0.8],
                    box.size * rng.uniform(0.8, 1.2, 3), box.ry + rng.randn() * 0.3,
                    box.velocity + rng.randn(2) * 0.5, int(rng.randint(0, 8)),
                    float(rng.rand())))
        for _ in range(rng.randint(0, 3)):
            frame_det.append(nuscenes_eval.NuscBox(
                classes[rng.randint(len(classes))],
                np.array([rng.uniform(-30, 30), 1.0, rng.uniform(-30, 30)]),
                rng.uniform(0.4, 5.0, 3), 0.0, np.zeros(2), 0, float(rng.rand())))
        gts.append(frame_gt)
        dets.append(frame_det)
    return gts, dets


def _as_jax(frames):
    return [[jeval.NuscBox(**dataclasses.asdict(b)) for b in frame] for frame in frames]


def test_nusc_metric_matches_jax():
    """AP at each threshold, the TP errors, mAP and NDS of the port's copy
    equal the JAX package's within METRIC_TOL, barrier and traffic cone
    (the class exceptions) included."""
    classes = ("car", "pedestrian", "barrier", "traffic_cone", "bus")
    gts, dets = _metric_boxes(5, classes)
    got = nuscenes_eval.evaluate_nuscenes(gts, dets, list(classes))
    want = jeval.evaluate_nuscenes(_as_jax(gts), _as_jax(dets), list(classes))
    assert set(got["per_class"]) == set(want["per_class"]) == set(classes)
    for cls in classes:
        g, w = got["per_class"][cls], want["per_class"][cls]
        assert set(g) == set(w)
        np.testing.assert_allclose(g["ap"], w["ap"], rtol=0, atol=METRIC_TOL)
        for key in set(w) - {"ap"}:
            assert abs(g[key] - w[key]) <= METRIC_TOL, (cls, key)
    for key in ("mAP", "NDS"):
        assert abs(got[key] - want[key]) <= METRIC_TOL, key
    assert 0.05 < want["mAP"] < 0.95 and 0.1 < want["NDS"] < 0.95


def test_nusc_metric_of_the_ground_truth_is_one(tree):
    """The GT of the converted val split, read back by the loader and taken
    as detections (with scores, one-hot attribute logits): mAP and NDS 1,
    on the classes present."""
    cfg = config.load_cfg(TINY, _opts(tree))
    loader = nuscenes.NuScenesLoader(cfg, "val", training=False)
    cls_list = list(cfg.DATASET.NUSCENES.CLS_LIST)
    gts, dets = [], []
    rng = np.random.RandomState(0)
    for batch in loader.batches(1, epochs=1, shuffle=False):
        boxes, labels = batch["gt_boxes"][0], batch["gt_labels"][0]
        velo, attr = batch["gt_velocity"][0], batch["gt_attribute"][0]
        velo = np.where(np.isnan(velo), 0.0, velo)
        gts.append(gt_batch_to_nusc_boxes(boxes, labels, cls_list, velo, attr))
        keep = labels > 0
        logits = np.eye(8)[np.maximum(attr[keep], 0)]
        dets.append(detections_to_nusc_boxes(boxes[keep], rng.rand(keep.sum()),
                                             labels[keep] - 1, cls_list, velo[keep], logits))
    present = sorted({b.cls for frame in gts for b in frame})
    assert len(present) >= 3
    res = nuscenes_eval.evaluate_nuscenes(gts, dets, present)
    assert res["mAP"] == pytest.approx(1.0, abs=1e-12)
    assert res["NDS"] == pytest.approx(1.0, abs=1e-12)


# ------------------------------------------------------------------- model

def _inside_boxes(batch: dict, frac: float, seed: int) -> dict:
    """The batch with a share of each scan's points redrawn inside its GT
    boxes (bottom face at the box's y), so a 2,048-point scan has
    positives."""
    rng = np.random.RandomState(seed)
    out = {k: np.array(v) for k, v in batch.items() if k != "names"}
    n = out["points"].shape[1]
    for b in range(len(out["points"])):
        boxes = out["gt_boxes"][b][out["gt_labels"][b] > 0]
        k = int(n * frac)
        box = boxes[rng.randint(0, len(boxes), k)]
        local = rng.uniform(-0.45, 0.45, (k, 3)) * box[:, [3, 4, 5]]
        local[:, 1] -= box[:, 4] / 2.0
        c, s = np.cos(box[:, 6]), np.sin(box[:, 6])
        xyz = np.stack([c * local[:, 0] + s * local[:, 2], local[:, 1],
                        -s * local[:, 0] + c * local[:, 2]], -1) + box[:, :3]
        out["points"][b, n - k:, :3] = xyz.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def tiny_run(tree):
    """The tiny nuScenes config at f32, seeded flax variables and two scans
    of the converted tree with points inside their boxes."""
    cfg = config.load_cfg(TINY, _opts(tree) + ["TPU.COMPUTE_DTYPE", "float32"])
    jcfg = jax_load_cfg(TINY, _opts(tree) + ["TPU.COMPUTE_DTYPE", "float32"])
    batch = next(jnusc.NuScenesLoader(jcfg, "train", seed=1).batches(2, epochs=1))
    data = _inside_boxes(batch, 0.3, 1)
    data["gt_velocity"][0, 0] = np.nan  # an isolated annotation's velocity
    jmodel, jspec = jax_build_detector(jcfg)
    shapes = jax.eval_shape(lambda p: jmodel.init(jax.random.PRNGKey(0), p, False),
                            jnp.asarray(data["points"][:1]))
    return cfg, jcfg, jmodel, jspec, ttrain._fill(shapes, 12), data


def test_tiny_heads_and_detections_match_jax(tiny_run):
    """The f32 forward of the tiny config on converted weights: sampling
    picks equal; every head output, attribute and velocity included, within
    HEAD_RTOL of its largest |value|; keep sets equal and the kept boxes'
    velocities and attributes gathered from their source points."""
    cfg, _, jmodel, jspec, variables, data = tiny_run
    pts = data["points"]

    def fwd(v, p):
        out, state = jmodel.apply(
            v, p, False, mutable=["intermediates"],
            capture_intermediates=lambda mdl, _: isinstance(mdl, JaxPointBackbone))
        net = state["intermediates"]["backbone"]["__call__"][0]
        return out, jspec.decode_and_nms(out), net["fps_idx"]

    out_j, det_j, picks_j = jax.jit(fwd)(variables, jnp.asarray(pts))
    model, spec = build_detector(cfg, device="cpu")
    sd = flax_to_state_dict(variables)
    assert set(model.state_dict()) == set(sd)
    assert {"head0.pred_attr.conv.kernel", "head0.pred_velo_base.bn.mean"} <= set(sd)
    model.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        out_t = model(_t(pts))
        det_t = spec.decode_and_nms(out_t)
    for layer, (fj, ft) in enumerate(zip(picks_j, out_t["fps_idx"])):
        assert (fj is None) == (ft is None), layer
        if fj is not None:
            np.testing.assert_array_equal(ft.numpy(), np.asarray(fj), err_msg=f"layer {layer}")
    assert out_t["attribute"].shape == (2, 32, 1, 8) and out_t["velocity"].shape == (2, 32, 1, 2)
    for key in ("base_xyz", "cls", "offset", "angle_cls", "angle_res", "attribute", "velocity"):
        want = np.asarray(out_j[key])
        err = np.abs(out_t[key].numpy() - want).max()
        assert err <= HEAD_RTOL * np.abs(want).max(), (key, err)
    assert set(det_t) == set(det_j) and det_t["boxes"].shape == (2, 4 * 100, 7)
    assert_same_keeps({k: v.numpy() for k, v in det_t.items()},
                      {k: np.asarray(v) for k, v in det_j.items()}, 100)


def assert_same_keeps(got: dict, want: dict, max_output: int) -> None:
    """Each scan's and class's keep set (the kept source points) equal, and
    each kept point's box, score, velocity and attribute within HEAD_RTOL of
    the key's largest |value|. Seeded weights give many candidates the same
    score to the last bit; the two packages may order such a tie apart,
    so a kept point may sit at another place of its block, but only among
    scores within HEAD_RTOL of each other."""
    bs, k = want["valid"].shape
    checked = 0
    for b in range(bs):
        for c0 in range(0, k, max_output):
            rows = slice(c0, c0 + max_output)
            pos = {}
            for side, det in (("got", got), ("want", want)):
                valid = det["valid"][b, rows]
                pos[side] = {int(i): j for j, i in enumerate(det["index"][b, rows]) if valid[j]}
            assert set(pos["got"]) == set(pos["want"]), (b, c0)
            for i, jw in pos["want"].items():
                jg = pos["got"][i]
                for key in ("boxes", "scores", "velocity", "attribute"):
                    scale = np.abs(want[key]).max()
                    g, w = got[key][b, c0 + jg], want[key][b, c0 + jw]
                    assert np.abs(g - w).max() <= HEAD_RTOL * scale, (key, b, i)
                if jg != jw:
                    tie = want["scores"][b, c0 + min(jg, jw):c0 + max(jg, jw) + 1]
                    assert tie.max() - tie.min() <= HEAD_RTOL * want["scores"].max(), (b, i)
                checked += 1
    np.testing.assert_array_equal(got["classes"], want["classes"])
    assert checked > 0


@pytest.mark.parametrize("method", ["Dist-Anchor-free", "Dist-Anchor"])
def test_decode_and_nms_gathers_velocity_and_attribute_as_jax(method):
    """Random head outputs of the 10-class config through both packages'
    decode and NMS: keep sets, and each kept box's velocity and attribute
    (its source point's, from slot min(class, reg_base - 1)), exactly."""
    opts = ["MODEL.FIRST_STAGE.REGRESSION_METHOD.TYPE", method,
            "MODEL.FIRST_STAGE.MAX_OUTPUT_NUM", "20"]
    _, jspec = jax_build_detector(jax_load_cfg(FULL, opts))
    _, tspec = build_detector(config.load_cfg(FULL, opts), device="cpu")
    rng = np.random.RandomState(6)
    b, n, c = 2, 96, 10
    base = 1 if method.endswith("free") else c
    outputs = {
        "base_xyz": rng.uniform(-20, 20, (b, n, 3)).astype(np.float32),
        "cls": rng.randn(b, n, c).astype(np.float32),
        "offset": (rng.randn(b, n, base, 6) * [1, 1, 1, 0.3, 0.3, 0.3]).astype(np.float32),
        "angle_cls": rng.randn(b, n, base, 12).astype(np.float32),
        "angle_res": (rng.rand(b, n, base, 12) - 0.5).astype(np.float32),
        "attribute": rng.randn(b, n, base, 8).astype(np.float32),
        "velocity": rng.randn(b, n, base, 2).astype(np.float32),
    }
    want = jspec.decode_and_nms({k: jnp.asarray(v) for k, v in outputs.items()})
    got = tspec.decode_and_nms({k: _t(v) for k, v in outputs.items()})
    assert set(got) == set(want)
    for key in ("classes", "valid", "index", "velocity", "attribute"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=1e-5,
                               atol=1e-5)
    idx, cls = got["index"].numpy(), got["classes"].numpy()
    slot = np.minimum(cls, base - 1)
    np.testing.assert_array_equal(
        got["velocity"].numpy(), outputs["velocity"][np.arange(b)[:, None], idx, slot])
    valid = got["valid"].numpy()
    assert valid.sum() > 20 and len(np.unique(cls[valid])) == c


def test_attr_velo_loss_and_gradients_match_jax():
    """Random logits, velocities and targets with attributes -1 and NaN
    velocities: both losses and their gradients as JAX's, no NaN in the
    gradient."""
    rng = np.random.RandomState(8)
    b, n, c = 2, 64, 3
    pmask = (rng.rand(b, n, c) < 0.3).astype(np.float32)
    velo = rng.randn(b, n, c, 2).astype(np.float32)
    velo[rng.rand(b, n) < 0.3] = np.nan
    targets = {"pmask": pmask, "gt_attribute": rng.randint(-1, 8, (b, n, c)).astype(np.int32),
               "gt_velocity": velo}
    outputs = {"attribute": rng.randn(b, n, c, 8).astype(np.float32),
               "velocity": rng.randn(b, n, c, 2).astype(np.float32)}
    lcfg = dict(cls_loss_type="Center-ness", cls_activation="Sigmoid", num_classes=c,
                num_angle_cls=12, attr_velo_loss=True)

    def jfn(o):
        a, v = jlosses.attr_velo_loss(jlosses.LossConfig(**lcfg), o,
                                      {k: jnp.asarray(x) for k, x in targets.items()})
        return a + 2.0 * v, (a, v)

    (_, want), want_g = jax.value_and_grad(jfn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in outputs.items()})
    tout = {k: _t(v).requires_grad_(True) for k, v in outputs.items()}
    got = losses.attr_velo_loss(losses.LossConfig(**lcfg), tout,
                                {k: _t(v) for k, v in targets.items()})
    (got[0] + 2.0 * got[1]).backward()
    for g, w in zip(got, want):
        assert abs(g.item() - float(w)) <= 1e-6 * abs(float(w)) and g.item() > 0
    for key in outputs:
        assert torch.isfinite(tout[key].grad).all(), key
        np.testing.assert_allclose(tout[key].grad.numpy(), np.asarray(want_g[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)


def _flatten64(tree) -> dict:
    """A flax tree of float64 leaves -> {dotted name: float64 tensor}."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[".".join(p.key for p in path)] = torch.from_numpy(np.array(leaf, np.float64))
    return out


def test_train_step_matches_jax(tiny_run, record_property):
    """One f32 loss and gradient of the tiny config in the port, against
    the JAX package's run in float64 from the same seeded state on the same
    batch (a GT with NaN velocity, GTs without attributes): every loss
    within STEP_LOSS_TOL of the largest, the attribute and velocity losses
    live; every gradient leaf and the moved BatchNorm statistics as
    tests/test_torch_train.py holds the flagship's. The float64 step is the
    reference, as for the two-stage steps (ROADMAP Queue 3 item k): on this
    batch of +-50 m scans the JAX package's own f32 step lies ~15% of a
    BatchNorm scale's gradient norm from it, the port's ~2e-5 (recorded)."""
    cfg, jcfg, jmodel, jspec, variables, data = tiny_run
    jgraph = JaxTrainGraph.build(jcfg, jmodel, jspec)
    bn_m = float(jschedules.bn_momentum(jcfg.SOLVER, 0))
    fn = jax.jit(jax.value_and_grad(jgraph.compute_losses, has_aux=True))
    _, grads32 = fn(variables["params"], variables["batch_stats"],
                    {k: jnp.asarray(v) for k, v in data.items()}, jax.random.PRNGKey(1), bn_m)
    with ttwo._float64():
        v64 = ttwo._to64(variables)
        fn = jax.jit(jax.value_and_grad(jgraph.compute_losses, has_aux=True))
        (total, (loss_dict, stats)), grads = fn(
            v64["params"], v64["batch_stats"], ttwo._to64(data), jax.random.PRNGKey(1), bn_m)
        want_losses = {k: float(v) for k, v in loss_dict.items()}
        total = float(total)
        want_grads = _flatten64(grads)
        want_stats = _flatten64(stats)
    jax_grads = flax_to_state_dict({"params": _np(grads32)})

    model, spec = build_detector(cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    graph = TrainGraph.build(cfg, model, spec)
    model.train()
    got_total, got_losses = graph.compute_losses(
        {k: _t(v) for k, v in data.items()}, schedules.bn_momentum(cfg.SOLVER, 0))
    got_total.backward()
    keys = {"cls", "offset", "angle", "corner", "vote", "attribute", "velocity"}
    assert set(got_losses) == set(want_losses) == keys
    largest = max(abs(float(v)) for v in want_losses.values())
    for key, value in got_losses.items():
        assert abs(value.item() - want_losses[key]) <= STEP_LOSS_TOL * largest, key
        assert np.isfinite(value.item()) and value.item() > 0, key
    assert abs(got_total.item() - total) <= STEP_LOSS_TOL * largest
    named = dict(model.named_parameters())
    assert set(named) == set(want_grads)
    worst = {"port": 0.0, "jax": 0.0}
    for name, p in named.items():
        g = p.grad
        assert g is not None and torch.isfinite(g).all(), name
        ref = want_grads[name]
        if name.endswith("conv.bias") and name[:-9] + "bn.scale" in named:
            ref = want_grads[name[:-4] + "kernel"]  # the bias before a BatchNorm
        err = float((g.double() - want_grads[name]).norm() / ref.norm())
        assert err <= ttrain.FLAGSHIP_GRAD_TOL, (name, err)
        worst["port"] = max(worst["port"], err)
        worst["jax"] = max(worst["jax"], float(
            (jax_grads[name].double() - want_grads[name]).norm() / ref.norm()))
    for side, err in worst.items():
        record_property(f"{side}_f32_grad_from_float64", err)
    assert named["head0.pred_attr.conv.kernel"].grad.abs().max() > 0
    assert named["head0.pred_velo.conv.kernel"].grad.abs().max() > 0
    buffers = dict(model.named_buffers())
    assert set(want_stats) == {k for k in buffers if k.endswith((".mean", ".var"))}
    for name, value in want_stats.items():
        ttrain._close_rel(buffers[name].numpy(), value.numpy(), ttrain.STATS_RTOL, name)


# ------------------------------------------------------------- the configs

def test_nuscenes_mean_sizes_and_anchors_match_jax():
    cls_list = config.load_cfg(FULL).DATASET.NUSCENES.CLS_LIST
    assert len(cls_list) == 10
    pts = np.random.RandomState(2).uniform(-40, 40, (2, 50, 3)).astype(np.float32)
    for method in ("Dist-Anchor", "Bin-Anchor", "Dist-Anchor-free"):
        got = box_coders.AnchorGenerator("NuScenes", cls_list, method)(_t(pts))
        want = jcoders.AnchorGenerator("NuScenes", cls_list, method)(jnp.asarray(pts))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=method)
    assert box_coders.MEAN_SIZES == {k: v for k, v in jcoders.MEAN_SIZES.items()
                                     if k.split("_")[0] in ("Kitti", "NuScenes")}


def test_full_config_builds_on_the_card_by_default():
    """The shipped nuScenes 3DSSD: 10 classes, anchor-free (one regression
    slot), the attribute / velocity branches at 128 wide, 200 outputs a
    class, bf16; on the card unless asked for the CPU. A two-stage config
    takes the nuScenes classes too."""
    cfg = config.load_cfg(FULL)
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="is_available"):
        build_detector(cfg)
    model, spec = build_detector(cfg, device="cpu")
    head = model.head0
    assert len(spec.cls_list) == 10 and spec.max_output == 200 and head.reg_base == 1
    assert head.pred_attr_base.conv.kernel.shape == (128, 128)
    assert head.pred_attr.conv.kernel.shape == (128, 8)
    assert head.pred_velo.conv.kernel.shape == (128, 2)
    assert head.pred_attr_base.conv.compute_dtype == torch.bfloat16
    rcnn = config.load_cfg(str(REPO / "configs/kitti/pointrcnn/pointrcnn_tiny_stage2.yaml"),
                           ["DATASET.TYPE", "NuScenes"])
    _, rpn_spec, rcnn_spec = build_two_stage(rcnn, device="cpu")
    assert rpn_spec.cls_list == rcnn_spec.cls_list == tuple(cfg.DATASET.NUSCENES.CLS_LIST)
