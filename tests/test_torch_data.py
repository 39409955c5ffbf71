"""The port's data pipeline (`ssd3d_torch/data`, `utils/viz.py`) against the
JAX package's: the same synthetic KITTI tree gives equal npz splits and
mixup database, the loader gives equal batches for the same seed on
threads and on worker processes started by fork, spawn or forkserver
(including a resumed stream), and every augmentation stage, IO helper and
HTML dump of the copies gives the original's values exactly. Inputs are made
from seeds with numpy."""

from __future__ import annotations

import os
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest

from ssd3d import config as jconfig
from ssd3d.data import augment as jaug
from ssd3d.data import kitti_io as jio
from ssd3d.data.loader import KittiLoader as JaxKittiLoader
from ssd3d.data.loader import budget_points as jax_budget_points
from ssd3d.data.preprocess import run_preprocess as jax_run_preprocess
from ssd3d.utils import viz as jviz
from ssd3d_torch import config
from ssd3d_torch.data import augment, build_loader, kitti_io, loader
from ssd3d_torch.data.loader import KittiLoader, budget_points
from ssd3d_torch.data.nuscenes import NuScenesLoader
from ssd3d_torch.data.preprocess import run_preprocess
from ssd3d_torch.utils import synth, viz

REPO = Path(__file__).resolve().parents[1]
TINY = str(REPO / "configs/kitti/3dssd/3dssd_tiny.yaml")
FLAGSHIP = str(REPO / "configs/kitti/3dssd/3dssd.yaml")


def _opts(data, npz):
    return ["DATASET.KITTI.BASE_DIR_PATH", str(data),
            "DATASET.KITTI.TRAIN_LIST", str(data / "train.txt"),
            "DATASET.KITTI.VAL_LIST", str(data / "val.txt"),
            "DATASET.KITTI.TEST_LIST", str(data / "test.txt"),
            "DATASET.KITTI.SAVE_NUMPY_PATH", str(npz),
            "TRAIN.AUGMENTATIONS.MIXUP.NUMBER", "(3, )"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A synthetic KITTI tree preprocessed by both packages: -> (root,
    port's npz dir, JAX's npz dir)."""
    root = tmp_path_factory.mktemp("kitti")
    synth.write_tree(str(root / "kitti"), n_train=5, n_val=3, n_points=3000, seed=1, k_max=4,
                     n_test=2)
    for pkg, run in (("port", run_preprocess), ("jax", jax_run_preprocess)):
        load = config.load_cfg if pkg == "port" else jconfig.load_cfg
        for split in ("train", "val", "test"):
            cfg = load(TINY, _opts(root / "kitti", root / pkg))
            if split != "train":
                cfg.TRAIN.AUGMENTATIONS.MIXUP.OPEN = False
            run(cfg, split, log=lambda *a: None)
    return root


def _files(root: Path) -> list[Path]:
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


def test_preprocess_writes_the_same_splits_and_mixup_database(tree):
    want, got = tree / "jax", tree / "port"
    files = _files(want)
    assert _files(got) == files
    assert {f.parts[0] for f in files} == {"train", "val", "test", "mixup_database"}
    n_npz = 0
    for rel in files:
        if rel.suffix != ".npz":
            assert (got / rel).read_bytes() == (want / rel).read_bytes(), rel
            continue
        a, b = np.load(got / rel), np.load(want / rel)
        assert sorted(a.files) == sorted(b.files), rel
        for k in b.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (rel, k)
            assert a[k].tobytes() == b[k].tobytes(), (rel, k)
        n_npz += 1
    assert n_npz >= 5 + 3 + 2 + 3  # scans of three splits and some mixup crops


def _loaders(tree, seed=7, training=True, split="train"):
    opts = _opts(tree / "kitti", tree / "port")
    port = KittiLoader(config.load_cfg(TINY, opts), split, training=training, seed=seed)
    ref = JaxKittiLoader(jconfig.load_cfg(TINY, opts), split, training=training, seed=seed)
    return port, ref


def _assert_batches_equal(got, want):
    assert len(got) == len(want) and len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("workers", [dict(num_threads=1), dict(num_threads=3),
                                     dict(num_procs=2, mp_method="fork"),
                                     dict(num_procs=2, mp_method="spawn"),
                                     dict(num_procs=2, mp_method="forkserver")])
@pytest.mark.parametrize("start_iter", [0, 3])
def test_loader_batches_equal_the_reference(tree, workers, start_iter):
    """Training batches (mixup, flip, per-object noise, global rotation and
    scale, stray-point filter, point budget) for the same seed, over three
    epochs, from the stream's start and resumed at batch 3."""
    port, ref = _loaders(tree)
    want = list(ref.batches(2, epochs=3, num_threads=1, start_iter=start_iter))
    got = list(port.batches(2, epochs=3, start_iter=start_iter, **workers))
    assert len(want) == 7 - start_iter  # 3 epochs of 5 scans, one stream, batch 2
    _assert_batches_equal(got, want)


def test_eval_loader_batches_equal_the_reference(tree):
    port, ref = _loaders(tree, seed=0, training=False, split="val")
    want = list(ref.batches(1, epochs=1, num_threads=1, shuffle=False))
    _assert_batches_equal(list(port.batches(1, epochs=1, num_threads=1, shuffle=False)), want)
    assert [int(b["names"][0]) for b in want] == [5, 6, 7]


def test_batches_passes_mp_method_to_the_workers(tree, monkeypatch):
    """The repair of the reference's `batches`, which drops `mp_method`
    and always forks (ssd3d/data/loader.py:283, :310-312, :360-361)."""
    asked = []
    real = loader.mp.get_context

    def get_context(method=None):
        asked.append(method)
        return real(method)

    monkeypatch.setattr(loader.mp, "get_context", get_context)
    port, _ = _loaders(tree)
    next(port.batches(2, num_procs=1, mp_method="spawn"))
    assert asked == ["spawn"]


class DyingLoader(KittiLoader):
    """A loader whose worker exits without a word at its first sample."""

    def load_sample(self, index, epoch_seed=0):
        os._exit(3)


@pytest.mark.parametrize("mp_method", ["spawn", "forkserver"])
def test_dead_worker_trips_the_watchdog(tree, mp_method):
    opts = _opts(tree / "kitti", tree / "port")
    dying = DyingLoader(config.load_cfg(TINY, opts), "train", training=True, seed=0)
    with pytest.raises(RuntimeError, match="died without delivering its sentinel"):
        next(dying.batches(2, num_procs=1, mp_method=mp_method))


def test_flagship_scans_keep_more_points_than_the_flagship_samples(tmp_path):
    """`write_tree`'s default of 20,000 points a scan leaves more than the
    flagship's 16,384 after the image-frustum and range crop."""
    data = tmp_path / "kitti"
    synth.write_tree(str(data), n_train=3, n_val=1, seed=0)
    cfg = config.load_cfg(FLAGSHIP, _opts(data, tmp_path / "npz"))
    kept = run_preprocess(cfg, "train", log=lambda *a: None)
    sizes = [len(np.load(tmp_path / "npz" / "train" / f"{i:06d}.npz")["points"]) for i in kept]
    assert len(kept) == 3 and min(sizes) > cfg.MODEL.POINTS_NUM_FOR_TRAINING


def test_build_loader_names_what_is_not_ported(tree, tmp_path):
    """Every dataset the JAX package loads is ported: KITTI, and nuScenes
    (its loader, `tests/test_torch_nuscenes.py`); an unknown DATASET.TYPE
    is named. Device augmentation is ported: the loader then augments
    nothing on the host and emits the road plane and the GT-crop
    candidates as the reference's loader emits them."""
    cfg = config.load_cfg(TINY, _opts(tree / "kitti", tree / "port"))
    assert isinstance(build_loader(cfg, "train"), KittiLoader)
    dev = build_loader(cfg, "train", device_aug=True)
    assert dev.device_aug and dev.augmentor is None
    ref = JaxKittiLoader(jconfig.load_cfg(TINY, _opts(tree / "kitti", tree / "port")),
                         "train", device_aug=True)
    got, want = dev.load_sample(0, 0), ref.load_sample(0, 0)
    assert set(got) == set(want) >= {"plane", "cand_points", "cand_boxes", "cand_labels",
                                     "cand_valid"}
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    (tmp_path / "list.txt").write_text("")
    cfg.DATASET.TYPE = "NUSCENES"
    assert isinstance(build_loader(cfg, "train", data_dir=str(tmp_path)), NuScenesLoader)
    cfg.DATASET.TYPE = "Lyft"
    with pytest.raises(ValueError, match="unknown DATASET.TYPE 'Lyft'"):
        build_loader(cfg, "train")


# ------------------------------------------------------------ augmentation

def _scene(seed):
    rng = np.random.default_rng(seed)
    pts, boxes = synth.make_scene(rng, n_points=3000, k_max=5)
    inside = augment.points_in_boxes_np(pts, boxes, expand=0.1)
    sem = inside.any(axis=1).astype(np.int32)
    return pts, boxes, sem, np.ones(len(pts), np.float32)


def _stage(mod, name, seed):
    pts, boxes, sem, dist = _scene(seed)
    rng = np.random.default_rng(seed + 100)
    classes = np.ones(len(boxes), np.int32)
    plane = np.array([0.0, -1.0, 0.0, 1.65])
    if name == "points_in_boxes_np":
        return mod.points_in_boxes_np(pts, boxes, expand=0.2)
    if name == "bev_corners":
        return mod.bev_corners(boxes, np.asarray((0.5, 2.0, 0.5)))
    if name == "bev_collision":
        shifted = boxes.copy()
        shifted[:, 0] += rng.uniform(-3, 3, len(boxes))
        return mod.bev_collision(mod.bev_corners(boxes), mod.bev_corners(shifted))
    if name == "flip_x":
        return mod.flip_x(pts, boxes)
    if name == "per_object_noise":
        return mod.per_object_noise(rng, boxes, pts, sem, expand=0.1)
    if name == "global_rotation":
        return mod.global_rotation(rng, pts, boxes, np.pi / 4)
    if name == "global_scale":
        return mod.global_scale(rng, pts, boxes, 0.05)
    if name == "filter_stray_points":
        return mod.filter_stray_points(boxes, pts, sem, dist)
    if name == "mixup_place":
        s_pts, s_boxes = synth.make_scene(np.random.default_rng(seed + 1), n_points=500, k_max=4)
        crops = [s_pts[mod.points_in_boxes_np(s_pts, s_boxes[i:i + 1])[:, 0]]
                 for i in range(len(s_boxes))]
        return mod.mixup_place(rng, s_boxes, np.ones(len(s_boxes), np.int32), crops,
                               boxes, classes, pts, sem, dist, plane)
    if name == "budget_points":
        return (budget_points if mod is augment else jax_budget_points)(rng, pts, sem, dist, 4096)
    raise AssertionError(name)


@pytest.mark.parametrize("name", ["points_in_boxes_np", "bev_corners", "bev_collision", "flip_x",
                                  "per_object_noise", "global_rotation", "global_scale",
                                  "filter_stray_points", "mixup_place", "budget_points"])
@pytest.mark.parametrize("seed", [0, 1])
def test_augmentation_stage_gives_the_references_values(name, seed):
    got, want = _stage(augment, name, seed), _stage(jaug, name, seed)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------ IO and viz

def test_kitti_io_reads_what_the_reference_reads(tree):
    root = str(tree / "kitti")
    port, ref = kitti_io.KittiScene(root), jio.KittiScene(root)
    for idx in (0, 4):
        np.testing.assert_array_equal(port.lidar(idx), ref.lidar(idx))
        for attr in ("P", "V2C", "R0", "C2V"):
            np.testing.assert_array_equal(getattr(port.calib(idx), attr),
                                          getattr(ref.calib(idx), attr))
        pts = port.lidar(idx)[:50, :3]
        np.testing.assert_array_equal(port.calib(idx).velo_to_rect(pts),
                                      ref.calib(idx).velo_to_rect(pts))
        np.testing.assert_array_equal(port.plane(idx), ref.plane(idx))
        assert port.image_size(idx) == ref.image_size(idx) == (375, 1242)
        got, want = port.labels(idx), ref.labels(idx)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.box_3d, w.box_3d)
            assert (g.type, g.truncation, g.occlusion, g.alpha) == \
                (w.type, w.truncation, w.occlusion, w.alpha)


def _png_pixels(path):
    """Decode the RGB PNG that `viz.write_rgb_png` writes -> uint8 [h, w, 3]."""
    data = Path(path).read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h, depth, color = struct.unpack(">IIBB", data[16:26])
    assert (depth, color) == (8, 2)
    idat, pos = b"", 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


@pytest.mark.parametrize("draw", ["draw_bev", "draw_scene_3d"])
def test_viz_draws_points_and_boxes_without_matplotlib(tmp_path, draw):
    pts, boxes, _, _ = _scene(3)
    path = tmp_path / "scene.png"
    getattr(viz, draw)(pts, str(path), gt_boxes=boxes, pred_boxes=boxes + 0.5,
                       pred_scores=np.ones(len(boxes)))
    img = _png_pixels(path)
    colors = {tuple(c) for c in img.reshape(-1, 3)[::7]}
    assert (0x2A, 0x9D, 0x3F) in colors and (0xE7, 0x6F, 0x2A) in colors  # GT, predictions
    assert (255, 255, 255) in colors and len(colors) > 3  # background and points
    getattr(viz, draw)(pts, str(tmp_path / "plain.png"))
    assert _png_pixels(tmp_path / "plain.png").shape == img.shape


def test_viz_html_and_corners_equal_the_reference(tmp_path):
    pts, boxes, _, _ = _scene(4)
    viz.dump_scene_html(pts, str(tmp_path / "got.html"), gt_boxes=boxes, pred_boxes=boxes[:1])
    jviz.dump_scene_html(pts, str(tmp_path / "want.html"), gt_boxes=boxes, pred_boxes=boxes[:1])
    assert (tmp_path / "got.html").read_bytes() == (tmp_path / "want.html").read_bytes()
    np.testing.assert_array_equal(viz._corners_3d(boxes), jviz._corners_3d(boxes))
    np.testing.assert_array_equal(viz._bev_corners(boxes), jviz._bev_corners(boxes))
