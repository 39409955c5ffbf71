"""The port's own copies of what it used to import from the JAX package (the
config loader and the synthetic scene and KITTI tree generator) against the
originals, and the entry points' default device."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from ssd3d import config as jconfig
from ssd3d_torch import config
from ssd3d_torch.utils import synth
from tools import synth_kitti

REPO = Path(__file__).resolve().parents[1]
YAMLS = sorted(str(p.relative_to(REPO)) for p in (REPO / "configs").rglob("*.yaml"))


@pytest.mark.parametrize("path", YAMLS)
def test_load_cfg_gives_the_jax_packages_tree(path):
    want = jconfig.load_cfg(str(REPO / path))
    got = config.load_cfg(str(REPO / path))
    assert got.to_dict() == want.to_dict()
    assert got.MODEL.NETWORK.FIRST_STAGE.ARCHITECTURE == want.MODEL.NETWORK.FIRST_STAGE.ARCHITECTURE


def test_load_cfg_overrides_and_defaults_match(tmp_path):
    opts = ["MODEL.FIRST_STAGE.MAX_OUTPUT_NUM", "64", "TPU.COMPUTE_DTYPE", "bfloat16"]
    got = config.load_cfg(str(REPO / YAMLS[0]), opts)
    assert got.to_dict() == jconfig.load_cfg(str(REPO / YAMLS[0]), opts).to_dict()
    assert got.MODEL.FIRST_STAGE.MAX_OUTPUT_NUM == 64
    assert config.get_default_cfg().to_dict() == jconfig.get_default_cfg().to_dict()
    bad = tmp_path / "bad.yaml"
    bad.write_text("MODEL:\n  NO_SUCH_KEY: 1\n")
    with pytest.raises(KeyError, match="Non-existent config key: MODEL.NO_SUCH_KEY"):
        config.load_cfg(str(bad))


@pytest.mark.parametrize("seed,n,k_max", [(0, 18432, 6), (3, 5000, 2)])
def test_make_scene_gives_the_same_arrays(seed, n, k_max):
    want_pts, want_boxes = synth_kitti.make_scene(np.random.default_rng(seed), n_points=n,
                                                  k_max=k_max)
    got_pts, got_boxes = synth.make_scene(np.random.default_rng(seed), n_points=n, k_max=k_max)
    np.testing.assert_array_equal(got_pts, want_pts)
    np.testing.assert_array_equal(got_boxes, want_boxes)
    assert got_pts.dtype == np.float32 and got_pts.shape[1] == 4 and len(got_boxes) >= 1


@pytest.mark.parametrize("hard", [False, True])
def test_write_tree_gives_the_same_files(tmp_path, hard):
    """`write_tree` (and the hard-mode multiclass scenes, labels, truncation
    and 2D projections it writes through) makes a byte-equal KITTI tree."""
    kw = dict(n_train=3, n_val=2, n_points=3000, seed=5, k_max=4, n_test=2, hard=hard)
    synth_kitti.write_tree(str(tmp_path / "want"), **kw)
    synth.write_tree(str(tmp_path / "got"), **kw)
    want = sorted(p.relative_to(tmp_path / "want") for p in (tmp_path / "want").rglob("*")
                  if p.is_file())
    got = sorted(p.relative_to(tmp_path / "got") for p in (tmp_path / "got").rglob("*")
                 if p.is_file())
    assert got == want and len(got) == 5 * 5 + 4 * 2 + 3
    for rel in want:
        assert (tmp_path / "got" / rel).read_bytes() == (tmp_path / "want" / rel).read_bytes(), rel


def test_hard_scene_helpers_give_the_same_values():
    want = synth_kitti.make_scene_hard(np.random.default_rng(2), n_points=4000, k_max=8)
    got = synth.make_scene_hard(np.random.default_rng(2), n_points=4000, k_max=8)
    np.testing.assert_array_equal(got[0], want[0])
    assert [(o["cls"], o["occ"]) for o in got[1]] == [(o["cls"], o["occ"]) for o in want[1]]
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a["box"], b["box"])
    for a, b in zip(got[2], want[2]):
        np.testing.assert_array_equal(a, b)
    p2 = np.array([[700, 0, 600, 44.8], [0, 700, 180, 0.1], [0, 0, 1, 0.003]], np.float32)
    for obj in want[1]:
        assert synth.truncation_of(obj["box"], p2) == synth_kitti.truncation_of(obj["box"], p2)
        assert synth.project_box2d(obj["box"], p2) == synth_kitti.project_box2d(obj["box"], p2)


@pytest.mark.parametrize("name", ["entry", "train_entry", "two_stage_entry"])
def test_entry_points_default_to_the_card_and_raise_without_one(name):
    from ssd3d_torch import entry

    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(entry, name)()


def test_pointrcnn_shrink_divides_the_rpn_sample_counts():
    """`pointrcnn(shrink=8)`: 2,048-point scans, the RPN's SA layers pick an
    eighth as many centres, widths and the RoI pool's 512 points stay."""
    from ssd3d_torch.entry import pointrcnn

    full = config.load_cfg(str(REPO / "configs/kitti/pointrcnn/pointrcnn_test.yaml"))
    cfg, model, rpn_spec, rcnn_spec, n = pointrcnn(shrink=8, device="cpu")
    assert n == full.MODEL.POINTS_NUM_FOR_TRAINING // 8 == 2048
    arch, full_arch = (c.MODEL.NETWORK.FIRST_STAGE.ARCHITECTURE for c in (cfg, full))
    assert [row[8] for row in arch[:4]] == [[p // 8 for p in row[8]] for row in full_arch[:4]]
    assert [row[4] for row in arch] == [row[4] for row in full_arch]
    assert model.roi_pool.sample_pts_num == 512 and not model.training
    assert rpn_spec.nms_pre_topk == 2048 and rcnn_spec.max_output == 100
    assert next(model.parameters()).device.type == "cpu"


def test_builders_default_to_the_card():
    from ssd3d_torch.models.api import build_pipeline
    from ssd3d_torch.models.single_stage import build_detector
    from ssd3d_torch.models.two_stage import build_two_stage

    cfg = config.load_cfg(str(REPO / "configs/kitti/pointrcnn/pointrcnn_test.yaml"))
    for build in (build_pipeline, build_two_stage):
        with pytest.raises(RuntimeError, match="is_available"):
            build(cfg)
    with pytest.raises(RuntimeError, match="is_available"):
        build_detector(config.load_cfg(str(REPO / "configs/kitti/3dssd/3dssd.yaml")))


@pytest.mark.parametrize("name", ["3dssd.yaml", "3dssd_tiny.yaml"])
def test_nuscenes_yamls_and_defaults_match(name):
    """Both nuScenes YAMLs give the JAX package's tree, with the nuScenes
    defaults (version, sweeps, paths, the 10-class list) where the YAML sets
    none."""
    path = REPO / "configs/nuscenes/3dssd" / name
    got, want = config.load_cfg(str(path)), jconfig.load_cfg(str(path))
    assert got.DATASET.NUSCENES.to_dict() == want.DATASET.NUSCENES.to_dict()
    assert got.to_dict() == want.to_dict()
    defaults = config.get_default_cfg().DATASET.NUSCENES
    assert defaults.to_dict() == jconfig.get_default_cfg().DATASET.NUSCENES.to_dict()
    assert len(defaults.CLS_LIST) == 10 and defaults.NSWEEPS == 10
    assert (defaults.VERSION, defaults.SAVE_NUMPY_PATH) == ("v1.0-trainval", "data/NuScenes")
    assert got.DATASET.TYPE == "NuScenes" and got.MODEL.FIRST_STAGE.PREDICT_ATTRIBUTE_AND_VELOCITY
    if name == "3dssd.yaml":
        assert got.DATASET.NUSCENES.CLS_LIST == defaults.CLS_LIST
        assert got.DATASET.NUSCENES.MAX_CUR_SAMPLE_POINTS_NUM == 16384
    else:
        assert got.DATASET.NUSCENES.VERSION == "v1.0-synth" and got.DATASET.NUSCENES.NSWEEPS == 4
