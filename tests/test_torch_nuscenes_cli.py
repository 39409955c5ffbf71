"""The port's nuScenes CLI chain as a user runs it: `python -m ssd3d_torch.bin.
{preprocess,train,evaluate,test}` as subprocesses with `--device cpu` on the
tiny nuScenes config (2,048 points, 4 classes) over a synthetic raw tree
written by `ssd3d_torch.utils.synth_nuscenes`, as tests/test_e2e_cli.py runs
the JAX package's chain. Checks that every CLI exits 0, that the converted
tree equals the JAX converter's, and that training, the NDS evaluation and
the submission JSON write what they should."""

from __future__ import annotations

import json
import os

import numpy as np

from ssd3d.data.nuscenes import convert_raw_nuscenes as jax_convert_raw_nuscenes
from ssd3d_torch.utils import synth_nuscenes

from test_torch_e2e_cli import _run
from test_torch_nuscenes import assert_same_npz_tree

CFG = "configs/nuscenes/3dssd/3dssd_tiny.yaml"
CLASSES = ("car", "pedestrian", "traffic_cone", "barrier")


def test_cli_nuscenes_preprocess_train_evaluate_test(tmp_path):
    raw, npz, run = tmp_path / "raw", tmp_path / "npz", tmp_path / "run"
    synth_nuscenes.write_tree(str(raw), n_scenes=3, samples_per_scene=3, n_points=3000, seed=4)
    opts = ["--device", "cpu",
            "DATASET.NUSCENES.BASE_DIR_PATH", str(raw),
            "DATASET.NUSCENES.SAVE_NUMPY_PATH", str(npz),
            "TRAIN.CONFIG.MAX_ITERATIONS", "2",
            "TRAIN.CONFIG.CHECKPOINT_INTERVAL", "1",
            "TRAIN.CONFIG.SUMMARY_INTERVAL", "1",
            "TEST.BATCH_SIZE", "2"]

    _run("ssd3d_torch.bin.preprocess", ["--cfg", CFG] + opts)
    jax_convert_raw_nuscenes("v1.0-synth", str(raw), str(tmp_path / "jax"), nsweeps=4,
                             log=lambda *a: None)
    assert_same_npz_tree(npz, tmp_path / "jax")
    assert len((npz / "train" / "list.txt").read_text().split()) == 6
    assert len((npz / "val" / "list.txt").read_text().split()) == 3

    _run("ssd3d_torch.bin.train", ["--cfg", CFG, "--log_dir", str(run)] + opts)
    metrics = [json.loads(line) for line in open(run / "metrics.jsonl")]
    assert [m["iter"] for m in metrics] == [1, 2]
    for m in metrics:
        assert {"attribute", "velocity"} <= set(m)
        assert all(np.isfinite(v) for v in m.values()), m
    assert sorted(os.listdir(run / "ckpt")) == ["1", "2"]

    _run("ssd3d_torch.bin.evaluate", ["--cfg", CFG, "--log_dir", str(run), "--once",
                                      "--cls_threshold", "0.0"] + opts)
    assert sorted(f for f in os.listdir(run) if f.startswith("eval_")) == \
        ["eval_1.json", "eval_2.json"]
    final = json.load(open(run / "eval_2.json"))
    assert set(final["per_class"]) == set(CLASSES)
    assert 0.0 <= final["mAP"] <= 1.0 and 0.0 <= final["NDS"] <= 1.0
    assert set(final["tp_errors"]) == {"trans", "scale", "orient", "vel", "attr"}
    best = json.load(open(run / "best.json"))
    assert best["step"] in (1, 2) and best["metric"] == 100.0 * json.load(
        open(run / f"eval_{best['step']}.json"))["NDS"]

    _run("ssd3d_torch.bin.test", ["--cfg", CFG, "--log_dir", str(run),
                                  "--cls_threshold", "0.0"] + opts)
    dump = json.load(open(run / "nuscenes_result.json"))
    val = (npz / "val" / "list.txt").read_text().split()
    assert dump["meta"] == {"use_lidar": True} and sorted(dump["results"]) == sorted(val)
    records = [r for recs in dump["results"].values() for r in recs]
    assert records
    for r in records:
        assert set(r) == {"sample_token", "translation_cam", "size_lhw", "yaw_cam",
                          "velocity_cam", "detection_name", "detection_score", "attribute_id"}
        assert r["detection_name"] in CLASSES and 0 <= r["attribute_id"] < 8
        assert len(r["translation_cam"]) == len(r["size_lhw"]) == 3
        assert len(r["velocity_cam"]) == 2 and np.isfinite(r["velocity_cam"]).all()
