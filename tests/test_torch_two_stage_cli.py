"""PointRCNN's stage-wise chain on the port's CLIs, as a user runs it on the
CPU (`--device cpu`): `bin.train` of stage 1 (the RPN), `bin.train` of
stage 2 warm-started from it by `--restore_model_path` with the RPN frozen,
then `bin.evaluate` of the stage-2 run. The port's twin of the JAX
package's `tests/test_e2e_cli.py::test_cli_pointrcnn_stagewise`, at the
in-repo tiny configs and a size that finishes in well under a minute."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ssd3d_torch.train.trainer import CheckpointManager
from ssd3d_torch.utils import synth

REPO = Path(__file__).resolve().parents[1]
CFG1 = "configs/kitti/pointrcnn/pointrcnn_tiny_stage1.yaml"
CFG2 = "configs/kitti/pointrcnn/pointrcnn_tiny_stage2.yaml"


def _run(module, argv):
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    p = subprocess.run([sys.executable, "-m", module] + argv, capture_output=True, text=True,
                       cwd=REPO, env=env, timeout=300)
    assert p.returncode == 0, (f"{module} failed rc={p.returncode}\n--- stdout\n"
                               f"{p.stdout[-1500:]}\n--- stderr\n{p.stderr[-1500:]}")
    return p


def test_cli_pointrcnn_stagewise(tmp_path):
    data, npz = tmp_path / "kitti", tmp_path / "npz"
    run1, run2 = tmp_path / "run_stage1", tmp_path / "run_stage2"
    synth.write_tree(str(data), n_train=4, n_val=2, n_points=2600, seed=5, k_max=3)
    opts = ["--device", "cpu",
            "DATASET.KITTI.BASE_DIR_PATH", str(data),
            "DATASET.KITTI.TRAIN_LIST", str(data / "train.txt"),
            "DATASET.KITTI.VAL_LIST", str(data / "val.txt"),
            "DATASET.KITTI.SAVE_NUMPY_PATH", str(npz),
            "TRAIN.CONFIG.BATCH_SIZE", "2",
            "TRAIN.CONFIG.MAX_ITERATIONS", "4",
            "TRAIN.CONFIG.CHECKPOINT_INTERVAL", "4",
            "TRAIN.CONFIG.SUMMARY_INTERVAL", "1",
            "TRAIN.AUGMENTATIONS.MIXUP.NUMBER", "(3, )",
            "TEST.TEST_MODE", "Recall"]
    for split in ("train", "val"):
        _run("ssd3d_torch.bin.preprocess", ["--cfg", CFG1, "--img_list", split] + opts)

    _run("ssd3d_torch.bin.train", ["--cfg", CFG1, "--log_dir", str(run1)] + opts)
    _run("ssd3d_torch.bin.train", ["--cfg", CFG2, "--log_dir", str(run2),
                                   "--restore_model_path", str(run1)] + opts)
    assert "warm start from" in (run2 / "log_train.txt").read_text()
    metrics = [json.loads(line) for line in open(run2 / "metrics.jsonl")]
    assert [m["iter"] for m in metrics] == [1, 2, 3, 4]
    # stage 2 sums the RCNN's losses only (TRAIN_LOSS_PREFIX loss_stage1),
    # in f32 (the log's float64 sum of them agrees to f32 rounding)
    for m in metrics:
        stage2 = sum(v for k, v in m.items() if k.startswith("loss_stage1/"))
        assert np.isfinite(m["total"]) and m["total"] > 0
        assert m["total"] == pytest.approx(stage2, rel=1e-6)
    stage1 = [json.loads(line) for line in open(run1 / "metrics.jsonl")]
    assert not any(k.startswith("loss_stage1/") for k in stage1[0])

    ckpt1 = CheckpointManager(str(run1 / "ckpt")).restore()[0]["model"]
    ckpt2 = CheckpointManager(str(run2 / "ckpt")).restore()[0]["model"]
    rpn_params = [k for k in ckpt1 if k.startswith("rpn") and not k.endswith((".mean", ".var"))]
    rcnn_params = [k for k in ckpt1 if k.startswith(("rcnn", "roi"))
                   and not k.endswith((".mean", ".var"))]
    assert rpn_params and rcnn_params
    # warm-started, then frozen: bit for bit stage 1's
    for key in rpn_params:
        assert torch.equal(ckpt1[key], ckpt2[key]), key
    # the frozen RPN still ran in train mode: its running statistics moved
    assert any(not torch.equal(ckpt1[k], ckpt2[k]) for k in ckpt1
               if k.startswith("rpn") and k.endswith(".mean"))
    assert any((ckpt1[k] - ckpt2[k]).abs().max() > 1e-6 for k in rcnn_params), \
        "no RCNN parameter moved in stage 2"

    _run("ssd3d_torch.bin.evaluate", ["--cfg", CFG2, "--log_dir", str(run2), "--once",
                                      "--cls_threshold", "0.01"] + opts)
    final = json.load(open(run2 / "eval_4.json"))
    assert final["total"] > 0 and np.isfinite(final["recall"])
