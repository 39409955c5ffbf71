"""The port's CLI chain as a user runs it: `python -m ssd3d_torch.bin.
{preprocess,train,evaluate,test}` as subprocesses with `--device cpu` over a
synthetic on-disk KITTI tree, as tests/test_e2e_cli.py runs the JAX
package's chain, at a size that finishes in well under a minute. Checks that
every CLI exits 0 and writes its artifacts (npz splits, mixup database,
checkpoints, metrics, per-checkpoint evaluations, best.json, KITTI result
files), that a second `bin.train` resumes, and that a CLI asked for no
device raises a clear error where there is no card."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ssd3d_torch.utils import synth

REPO = Path(__file__).resolve().parents[1]
CFG = "configs/kitti/3dssd/3dssd_tiny.yaml"


def _run(module, argv, check=True):
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    p = subprocess.run([sys.executable, "-m", module] + argv, capture_output=True, text=True,
                       cwd=REPO, env=env, timeout=300)
    if check:
        assert p.returncode == 0, (f"{module} failed rc={p.returncode}\n--- stdout\n"
                                   f"{p.stdout[-1500:]}\n--- stderr\n{p.stderr[-1500:]}")
    return p


def test_cli_preprocess_train_evaluate_test(tmp_path):
    data, npz, run = tmp_path / "kitti", tmp_path / "npz", tmp_path / "run"
    synth.write_tree(str(data), n_train=4, n_val=2, n_points=2600, seed=3, k_max=3, n_test=2)
    opts = ["--device", "cpu",
            "DATASET.KITTI.BASE_DIR_PATH", str(data),
            "DATASET.KITTI.TRAIN_LIST", str(data / "train.txt"),
            "DATASET.KITTI.VAL_LIST", str(data / "val.txt"),
            "DATASET.KITTI.TEST_LIST", str(data / "test.txt"),
            "DATASET.KITTI.SAVE_NUMPY_PATH", str(npz),
            "TRAIN.CONFIG.BATCH_SIZE", "2",
            "TRAIN.CONFIG.MAX_ITERATIONS", "4",
            "TRAIN.CONFIG.CHECKPOINT_INTERVAL", "2",
            "TRAIN.CONFIG.SUMMARY_INTERVAL", "1",
            "TRAIN.AUGMENTATIONS.MIXUP.NUMBER", "(3, )"]

    for split in ("train", "val", "test"):
        _run("ssd3d_torch.bin.preprocess", ["--cfg", CFG, "--img_list", split] + opts)
        assert (npz / split / "list.txt").read_text().split() != []
    assert (npz / "mixup_database" / "KITTI" / "train" / "Car" / "list.txt").exists()

    _run("ssd3d_torch.bin.train", ["--cfg", CFG, "--log_dir", str(run)] + opts)
    metrics = [json.loads(line) for line in open(run / "metrics.jsonl")]
    assert [m["iter"] for m in metrics] == [1, 2, 3, 4]
    assert all(np.isfinite(m["total"]) for m in metrics)
    assert sorted(os.listdir(run / "ckpt")) == ["2", "4"]
    assert (run / "config_snapshot.json").exists()
    assert sorted(os.listdir(run / "bev")) == ["iter_0000002.png", "iter_0000004.png"]

    _run("ssd3d_torch.bin.evaluate", ["--cfg", CFG, "--log_dir", str(run), "--once",
                                      "--cls_threshold", "0.01"] + opts)
    assert sorted(f for f in os.listdir(run) if f.startswith("eval_")) == \
        ["eval_2.json", "eval_4.json"]
    final = json.load(open(run / "eval_4.json"))
    assert all(len(final["Car"][m]) == 3 and np.isfinite(final["Car"][m]).all()
               for m in ("image", "ground", "3d", "aos"))
    best = json.load(open(run / "best.json"))
    assert best["step"] in (2, 4) and (run / "best_ckpt" / "state.pt").exists()
    assert list((run / "scene3d_eval" / "ckpt_4").glob("*.html"))

    # one checkpoint, by the evaluator's --restore_model_path (a copied step dir)
    os.remove(run / f"eval_{best['step']}.json")
    _run("ssd3d_torch.bin.evaluate", ["--cfg", CFG, "--log_dir", str(run), "--restore_model_path",
                                      str(run / "best_ckpt"), "--viz_scans", "0"] + opts)
    assert (run / f"eval_{best['step']}.json").exists()

    # KITTI test-server submission: the label-free testing/ split
    _run("ssd3d_torch.bin.test", ["--cfg", CFG, "--log_dir", str(run), "--split", "test",
                                  "--cls_threshold", "0.01"] + opts)
    results = sorted(os.listdir(run / "kitti_result"))
    assert results == ["000000.txt", "000001.txt"]
    for line in open(run / "kitti_result" / results[0]):
        assert line.startswith("Car ") and len(line.split()) == 16, line

    # resume: a second bin.train on the same log_dir continues to 6
    _run("ssd3d_torch.bin.train", ["--cfg", CFG, "--log_dir", str(run),
                                   "--max_iterations", "6"] + opts)
    assert "restored checkpoint at step 4" in (run / "log_train.txt").read_text()
    assert [json.loads(line)["iter"] for line in open(run / "metrics.jsonl")][-2:] == [5, 6]
    assert sorted(os.listdir(run / "ckpt")) == ["2", "4", "6"]


def test_cli_without_device_raises_where_there_is_no_card(tmp_path):
    assert not torch.cuda.is_available()
    for module in ("ssd3d_torch.bin.train", "ssd3d_torch.bin.preprocess"):
        p = _run(module, ["--cfg", CFG, "--log_dir", str(tmp_path)] if module.endswith("train")
                 else ["--cfg", CFG], check=False)
        assert p.returncode != 0
        assert "torch.cuda.is_available() is false" in p.stderr and "device='cpu'" in p.stderr
    assert not (tmp_path / "ckpt").exists()
