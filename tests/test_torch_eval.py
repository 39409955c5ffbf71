"""The port's evaluation (`ssd3d_torch/eval`, `native`, `core/iou.py`)
against the JAX package's: KITTI AP equal on the port's native and numpy
paths and on the reference's, byte-equal KITTI result files, the rotated
BEV / 3D IoU within 1e-5, the recall counts equal, and the split inference
of the shrunk flagship at f32 with the same converted weights giving the
JAX package's detections. Inputs are made from seeds with numpy."""

from __future__ import annotations

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd3d import config as jconfig
from ssd3d.core.iou import boxes_iou_bev_3d as jax_iou
from ssd3d.data import kitti_io as jio
from ssd3d.data.loader import KittiLoader as JaxKittiLoader
from ssd3d.eval import kitti_ap as jap
from ssd3d.eval import predictions as jpred
from ssd3d.models.api import build_pipeline as jax_build_pipeline
from ssd3d_torch import config, native
from ssd3d_torch.core.iou import boxes_iou_bev_3d
from ssd3d_torch.data import kitti_io
from ssd3d_torch.data.loader import KittiLoader
from ssd3d_torch.data.preprocess import run_preprocess
from ssd3d_torch.eval import kitti_ap
from ssd3d_torch.eval import predictions as pred
from ssd3d_torch.models.api import build_pipeline
from ssd3d_torch.utils import synth
from ssd3d_torch.utils.convert import flax_to_state_dict

REPO = Path(__file__).resolve().parents[1]
FLAGSHIP = str(REPO / "configs/kitti/3dssd/3dssd.yaml")
# the IoU of two f32 implementations of the same polygon clip: each corner
# and area rounds once per operation, in another order
IOU_TOL = 1e-5
# detections of the shrunk flagship at f32, relative to the largest |value|
# of each compared field: sums over ~100 channels in another order
DET_TOL = 1e-4


# -------------------------------------------------------------- KITTI AP

def _obj(cls, rng, typ=None, x=None, z=None, score=-1000.0, **kw):
    return cls(type=typ or "Car", box2d=np.array([100.0, 100.0, 160.0, 100.0 + rng.uniform(20, 80)]),
               t=np.array([x if x is not None else rng.uniform(-30, 30), rng.uniform(1.4, 1.7),
                           z if z is not None else rng.uniform(5, 60)]),
               l=rng.uniform(3, 5), h=rng.uniform(1.4, 1.8), w=rng.uniform(1.5, 1.9),
               ry=rng.uniform(-np.pi, np.pi), alpha=rng.uniform(-np.pi, np.pi), score=score,
               truncation=kw.get("trunc", rng.choice([0.0, 0.2, 0.4])),
               occlusion=kw.get("occ", int(rng.integers(0, 3))))


def _eval_data(seed, n_images=20):
    """(gt, det) per image as reference EvalObjects: cars, pedestrians and
    cyclists across the difficulty gates, Van and DontCare distractors,
    jittered detections of most GTs and false positives."""
    rng = np.random.default_rng(seed)
    gts, dets = [], []
    for _ in range(n_images):
        frame = [_obj(jap.EvalObject, rng, typ=rng.choice(["Car", "Pedestrian", "Cyclist"]))
                 for _ in range(int(rng.integers(1, 6)))]
        frame.append(_obj(jap.EvalObject, rng, typ="Van", z=70.0))
        frame.append(_obj(jap.EvalObject, rng, typ="DontCare", z=75.0))
        d = []
        for o in frame[:-2]:
            if rng.random() < 0.8:
                d.append(dataclasses.replace(
                    o, t=o.t + rng.uniform(-0.4, 0.4, 3), ry=o.ry + rng.uniform(-0.2, 0.2),
                    box2d=o.box2d + rng.uniform(-4, 4, 4), score=float(rng.random())))
        for _ in range(int(rng.integers(0, 3))):
            d.append(_obj(jap.EvalObject, rng, typ=rng.choice(["Car", "Pedestrian"]),
                          score=float(rng.random())))
        gts.append(frame)
        dets.append(d)
    return gts, dets


def _port_objects(frames):
    return [[kitti_ap.EvalObject(**dataclasses.asdict(o)) for o in f] for f in frames]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kitti_ap_equal_on_native_numpy_and_reference(seed, monkeypatch):
    """The port's numpy path gives the reference's numpy path's numbers
    exactly, and the port's C++ path the same AP. AOS alone differs between
    the paths in its last digits: the C++ core reads the boxes as float32
    rows, the numpy path keeps them in float64; it is held to the
    reference's own native-against-numpy tolerance (1e-6 on the curve,
    tests/test_native.py), 1e-4 in AP percent. The reference's library is
    never built here: its numpy path is the one its `load` finding no
    library takes."""
    from ssd3d import native as jnative

    monkeypatch.setattr(jnative, "load", lambda *a, **k: None)
    gts, dets = _eval_data(seed)
    classes = ("Car", "Pedestrian", "Cyclist")
    assert native.load() is not None
    pg, pd = _port_objects(gts), _port_objects(dets)
    on_native = kitti_ap.evaluate_kitti_ap(pg, pd, classes, compute_aos=True)
    ref_numpy = jap.evaluate_kitti_ap(gts, dets, classes, compute_aos=True)
    monkeypatch.setattr(native, "load", lambda: None)
    on_numpy = kitti_ap.evaluate_kitti_ap(pg, pd, classes, compute_aos=True)
    assert on_numpy == ref_numpy
    for cls_name in classes:
        assert set(on_native[cls_name]) == {"image", "aos", "ground", "3d"}
        for metric in ("image", "ground", "3d"):
            assert on_native[cls_name][metric] == on_numpy[cls_name][metric]
        np.testing.assert_allclose(on_native[cls_name]["aos"], on_numpy[cls_name]["aos"],
                                   rtol=0, atol=1e-4)
    assert max(max(on_native[c]["3d"]) for c in classes) > 0
    with pytest.raises(RuntimeError, match="not built"):
        kitti_ap.eval_class(pg, pd, 0, 0, "3d", use_native=True)


def test_native_library_builds_into_the_build_directory():
    lib = native.load()
    assert lib is not None
    path = native.library_path()
    assert path.parent == REPO / "build" / "ssd3d_torch" and path.is_file()
    assert not list((REPO / "ssd3d_torch" / "native").glob("*.so"))


def test_voxel_budget_native_keeps_the_first_points_of_each_voxel():
    """The copy of `voxelize.cc` against the first-come cap that
    tests/test_native.py holds the reference's library to."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-45, 45, (20000, 4)).astype(np.float32)
    pts[:, 1] = rng.uniform(-4, 2, 20000)
    pts[:5000] = pts[0]  # pile into one voxel
    lo, hi, vs = np.array([-50.0, -5.0, -50.0]), np.array([50.0, 3.0, 50.0]), np.full(3, 0.2)
    got = native.voxel_budget_flags_native(pts, vs, lo, hi, 10)
    coords = np.floor((pts[:, :3] - lo) / vs).astype(np.int64)
    grid = np.ceil((hi - lo) / vs).astype(np.int64)
    inside = np.all((pts[:, :3] > lo) & (pts[:, :3] < hi), axis=1)
    flat = (coords[:, 0] * grid[1] + coords[:, 1]) * grid[2] + coords[:, 2]
    want = np.zeros(len(pts), bool)
    seen: dict = {}
    for i in np.where(inside)[0]:
        if seen.get(flat[i], 0) < 10:
            seen[flat[i]] = seen.get(flat[i], 0) + 1
            want[i] = True
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(pts) - 4000


# ------------------------------------------------------------ KITTI files

def _random_dets(seed, n=12):
    rng = np.random.default_rng(seed)
    boxes = np.stack([rng.uniform(-20, 20, n), rng.uniform(1.0, 2.0, n), rng.uniform(2, 60, n),
                      rng.uniform(3, 5, n), rng.uniform(1.4, 1.8, n), rng.uniform(1.5, 1.9, n),
                      rng.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)
    return boxes, rng.random(n).astype(np.float32), rng.integers(0, 3, n).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_kitti_result_files_and_eval_objects_equal_the_reference(tmp_path, seed):
    boxes, scores, classes = _random_dets(seed)
    cls_list = ["Car", "Pedestrian", "Cyclist"]
    p2 = np.array([[700, 0, 600, 44.8], [0, 700, 180, 0.1], [0, 0, 1, 0.003]], np.float32)
    for shape in [(375, 1242), (370, 1224)]:
        pred.save_kitti_predictions(str(tmp_path / "got.txt"), boxes, scores, classes, cls_list,
                                    p2, shape)
        jpred.save_kitti_predictions(str(tmp_path / "want.txt"), boxes, scores, classes, cls_list,
                                     p2, shape)
        assert (tmp_path / "got.txt").read_bytes() == (tmp_path / "want.txt").read_bytes()
        got = pred.detections_to_eval_objects(boxes, scores, classes, cls_list, p2, shape)
        want = jpred.detections_to_eval_objects(boxes, scores, classes, cls_list, p2, shape)
        assert [dataclasses.asdict(o).keys() for o in got] == \
            [dataclasses.asdict(o).keys() for o in want]
        for g, w in zip(got, want):
            for k, v in dataclasses.asdict(w).items():
                np.testing.assert_array_equal(getattr(g, k), v, err_msg=k)
    assert len((tmp_path / "got.txt").read_text().splitlines()) == len(boxes)
    pred.save_kitti_predictions(str(tmp_path / "empty.txt"), boxes[:0], scores[:0], classes[:0],
                                cls_list, p2)
    assert (tmp_path / "empty.txt").read_text() == ""


# ------------------------------------------------------------------ IoU

def _iou_cases():
    rng = np.random.default_rng(0)

    def rand(n, scale):
        return np.stack([rng.uniform(-scale, scale, n), rng.uniform(0.5, 2.5, n),
                         rng.uniform(5, 5 + 2 * scale, n), rng.uniform(0.5, 5, n),
                         rng.uniform(0.5, 3, n), rng.uniform(0.5, 5, n),
                         rng.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)

    base = np.array([[1.0, 1.5, 20.0, 4.0, 1.6, 2.0, 0.3]], np.float32)
    touching = base.copy()
    touching[0, 0] += 4.0 * np.cos(0.3)  # shifted one length along its heading: shares an edge
    touching[0, 2] -= 4.0 * np.sin(0.3)
    nested = base.copy()
    nested[0, 3:6] *= 0.5  # inside base, same centre and heading
    corner = base.copy()
    corner[0, 6] += np.pi / 4  # same centre, turned 45 degrees
    on_top = base.copy()
    on_top[0, 1] -= 1.6  # stacked: footprints equal, heights only touch
    axis = np.array([[0, 1, 10, 2, 1, 2, 0], [2, 1, 10, 2, 1, 2, 0],
                     [1, 1, 10, 2, 1, 2, 0], [0, 1, 10, 2, 1, 2, np.pi / 2]], np.float32)
    degenerate = np.concatenate([base, touching, nested, corner, on_top, axis,
                                 np.array([[5, 1, 30, 0.0, 1, 2, 0]], np.float32),
                                 rand(4, 5)])
    # every case [16, 16]: the JAX function, run eagerly, compiles once a shape
    return {"random_near": (rand(16, 5), rand(16, 5)), "random_far": (rand(16, 30), rand(16, 30)),
            "degenerate": (degenerate, degenerate)}


@pytest.mark.parametrize("case", ["random_near", "random_far", "degenerate"])
def test_boxes_iou_bev_3d_matches_jax(case):
    a, b = _iou_cases()[case]
    jb, j3 = (np.asarray(x) for x in jax.jit(jax_iou)(jnp.asarray(a), jnp.asarray(b)))
    tb, t3 = (x.numpy() for x in boxes_iou_bev_3d(torch.from_numpy(a), torch.from_numpy(b)))
    assert tb.shape == t3.shape == (len(a), len(b))
    np.testing.assert_allclose(tb, jb, rtol=0, atol=IOU_TOL)
    np.testing.assert_allclose(t3, j3, rtol=0, atol=IOU_TOL)
    assert (jb > 0.05).any()
    if case == "degenerate":
        assert abs(tb[0, 0] - 1) < IOU_TOL and abs(tb[0, 1]) < IOU_TOL  # itself; edge-touching
        assert abs(tb[0, 2] - 0.25) < IOU_TOL and abs(t3[0, 2] - 0.125) < IOU_TOL  # nested
        assert abs(tb[0, 4] - 1) < IOU_TOL and abs(t3[0, 4]) < IOU_TOL  # stacked


@pytest.mark.parametrize("iou_threshold", [0.5, 0.25])
def test_recall_counts_equal_the_reference(iou_threshold):
    """Detections and proposals near the GTs of six scans (one with no GT);
    three GTs and detections a scan, so the JAX side compiles one shape."""
    rng = np.random.default_rng(0)
    gts = [_random_dets(i, 3)[0] for i in range(5)] + [np.zeros((0, 7), np.float32)]
    dets, props = [], []
    for g in gts:
        moved = g + rng.normal(0, 0.3, g.shape).astype(np.float32)
        dets.append([kitti_ap.EvalObject(type="Car", box2d=np.zeros(4), t=b[:3], l=b[3], h=b[4],
                                         w=b[5], ry=b[6]) for b in moved])
        p = np.concatenate([moved, _random_dets(int(rng.integers(100)), 6)[0]])
        props.append((p, rng.random(len(p)) < 0.8))
    got = pred.evaluate_recall(dets, gts, iou_threshold)
    assert got == jpred.evaluate_recall(dets, gts, iou_threshold)
    assert pred.proposal_recall(props, gts, iou_threshold) == \
        jpred.proposal_recall(props, gts, iou_threshold)
    assert got[1] == 15 and 0 < got[0] < 15


# ------------------------------------------------------ split inference

def _filled(shapes, seed):
    """Seeded values for a flax variable tree: xavier-like kernels, small
    biases, BatchNorm statistics off their init."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            lim = np.sqrt(6.0 / (s.shape[0] + s.shape[1]))
            return rng.uniform(-lim, lim, s.shape)
        if name == "scale":
            return rng.uniform(0.8, 1.2, s.shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape)
        return rng.uniform(-0.1, 0.1, s.shape)

    return jax.tree_util.tree_map_with_path(lambda p, s: leaf(p, s).astype(np.float32), shapes)


def _shrunk(load, opts):
    """The flagship config at shrink 8 (2,048 points, full widths), f32."""
    cfg = load(FLAGSHIP, opts)
    for layer in cfg.MODEL.NETWORK.FIRST_STAGE.ARCHITECTURE:
        layer[6] = [r if r == -1 else r // 8 for r in layer[6]]
        layer[8] = [p if p == -1 else p // 8 for p in layer[8]]
    cfg.MODEL.POINTS_NUM_FOR_TRAINING //= 8
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


@pytest.fixture(scope="module")
def split_inference(tmp_path_factory):
    """Five preprocessed val scans, the JAX package's batch-1 split
    inference over them, and the port's pipeline with the same weights."""
    root = tmp_path_factory.mktemp("eval")
    data = root / "kitti"
    synth.write_tree(str(data), n_train=1, n_val=5, n_points=3000, seed=4, k_max=4)
    opts = ["DATASET.KITTI.BASE_DIR_PATH", str(data),
            "DATASET.KITTI.VAL_LIST", str(data / "val.txt"),
            "DATASET.KITTI.SAVE_NUMPY_PATH", str(root / "npz")]
    tcfg, jcfg = _shrunk(config.load_cfg, opts), _shrunk(jconfig.load_cfg, opts)
    tcfg.TRAIN.AUGMENTATIONS.MIXUP.OPEN = False
    run_preprocess(tcfg, "val", log=lambda *a: None)
    jpipe = jax_build_pipeline(jcfg)
    shapes = jax.eval_shape(lambda x: jpipe.model.init(jax.random.PRNGKey(0), x, False),
                            jnp.zeros((1, 2048, 4), jnp.float32))
    variables = _filled(shapes, 3)
    want = jpred.run_inference_on_split(
        jcfg, jpipe.infer, jpipe.cls_list, variables, JaxKittiLoader(jcfg, "val", training=False),
        jio.KittiScene(str(data)), cls_thresh=0.05, log=lambda *a: None,
        save_dir=str(root / "want"))
    pipe = build_pipeline(tcfg, device="cpu")
    pipe.model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return tcfg, pipe, data, root, want


def _run(split_inference, batch_size, save_dir=None, **kw):
    tcfg, pipe, data, root, _ = split_inference
    return pred.run_inference_on_split(
        tcfg, pipe, KittiLoader(tcfg, "val", training=False), kitti_io.KittiScene(str(data)),
        cls_thresh=0.05, log=lambda *a: None, batch_size=batch_size,
        save_dir=str(root / save_dir) if save_dir else None, **kw)


def _rows(dets):
    """Per scan, one row a detection: box (7), score, 2D box (4)."""
    return [np.array([[*d.t, d.l, d.h, d.w, d.ry, d.score, *d.box2d] for d in f],
                     np.float64).reshape(-1, 12) for f in dets]


def _assert_same_detections(got, want):
    """Equal keep sets with values within DET_TOL of the largest |value| of
    each field (boxes, scores, 2D boxes). Detections are matched by their
    boxes, not by their order: the order is by score, and the scores of a
    randomly initialised model lie so close together that rounding may swap
    two."""
    matched_got, matched_want = [], []
    for g, w in zip(_rows(got), _rows(want)):
        assert g.shape == w.shape  # as many kept in every scan
        if not len(w):
            continue
        d = np.abs(g[:, None, :7] - w[None, :, :7]).max(-1)
        pick = d.argmin(0)
        assert sorted(pick.tolist()) == list(range(len(w)))  # one to one
        matched_got.append(g[pick])
        matched_want.append(w)
    g, w = np.concatenate(matched_got), np.concatenate(matched_want)
    for what, cols in (("boxes", slice(0, 7)), ("scores", slice(7, 8)), ("2D boxes", slice(8, 12))):
        err, scale = np.abs(g[:, cols] - w[:, cols]).max(), np.abs(w[:, cols]).max()
        assert err <= DET_TOL * scale, (what, err, scale)
    return len(w)


def test_split_inference_gives_the_jax_packages_detections(split_inference):
    want_det, want_gt, want_names = split_inference[-1]
    det, gt, names = _run(split_inference, 1, save_dir="got")
    assert names == want_names == [1, 2, 3, 4, 5]
    assert _assert_same_detections(det, want_det) >= 10
    for g, w in zip(gt, want_gt):
        assert [dataclasses.asdict(o)["type"] for o in g] == [o.type for o in w]
    root = split_inference[3]
    assert sorted(p.name for p in (root / "got").iterdir()) == \
        sorted(p.name for p in (root / "want").iterdir())


def test_split_inference_batch_4_equals_batch_1(split_inference, tmp_path):
    """Five scans at batch 4: one full batch and one padded by repeating its
    last scan. The keep sets equal batch 1's and the values lie within
    DET_TOL of them: a GEMM over 4 scans' rows blocks its sums otherwise
    than one over 1 scan's, so the last bits of the f32 values may differ,
    and two detections of near-equal score may trade places."""
    det1, gt1, names1 = _run(split_inference, 1)
    props: list = []
    det4, gt4, names4 = _run(split_inference, 4, proposals_out=props,
                             viz_dir=str(tmp_path / "viz"), viz_scans=2)
    assert names4 == names1 and [len(f) for f in gt4] == [len(f) for f in gt1]
    assert _assert_same_detections(det4, det1) >= 10
    assert props == []  # single-stage: no proposals
    assert len(list((tmp_path / "viz").glob("*.png"))) == 2
    assert len(list((tmp_path / "viz").glob("*.html"))) == 2
