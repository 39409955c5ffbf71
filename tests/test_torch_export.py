"""Serving export of the port (`ssd3d_torch.bin.export`): artifacts made by
`torch.export` round-trip through `torch.export.save` / `load` and equal
live `Pipeline.infer` exactly, with a fixed and with a symbolic batch, on the
tiny 3DSSD, the tiny 3DSSD with attention grouping and the tiny nuScenes
3DSSD; the CLI writes
the artifact and its `.json` from a port checkpoint; and a process that
imports only `ssd3d_torch.ops` loads and runs it.
`tests/test_torch_export_two_stage.py` exports the tiny PointRCNN and
`tests/test_torch_export_jax.py` holds the exported program to the JAX
package's artifact."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ssd3d_torch.bin.export import export_infer
from ssd3d_torch.config import load_cfg
from ssd3d_torch.entry import init_weights, synthetic_scenes
from ssd3d_torch.models.api import build_pipeline
from ssd3d_torch.ops import _build
from ssd3d_torch.train.trainer import CheckpointManager

REPO = Path(__file__).resolve().parents[1]
TINY = REPO / "configs" / "kitti" / "3dssd" / "3dssd_tiny.yaml"
NUSC_TINY = REPO / "configs" / "nuscenes" / "3dssd" / "3dssd_tiny.yaml"


def _pipeline(cfg_path, seed=0, **kw):
    """The config's pipeline on the CPU with seeded weights."""
    cfg = load_cfg(str(cfg_path))
    pipe = build_pipeline(cfg, device="cpu", **kw)
    init_weights(pipe.model, seed)
    return cfg, pipe


def _scans(b, n, seed=1):
    return torch.from_numpy(synthetic_scenes(b, n, seed=seed)["points"])


def _round_trip(exported, path):
    torch.export.save(exported, str(path))
    return torch.export.load(str(path)).module()


def _assert_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key


def _custom_ops(exported) -> set[str]:
    return {str(node.target).split(".")[1] for node in exported.graph.nodes
            if node.op == "call_function" and str(node.target).startswith("ssd3d.")}


@pytest.fixture(scope="module")
def tiny():
    cfg, pipe = _pipeline(TINY)
    return cfg, pipe, cfg.MODEL.POINTS_NUM_FOR_TRAINING


def test_fixed_batch_artifact_equals_live(tiny, tmp_path):
    cfg, pipe, n = tiny
    exported = export_infer(pipe, 2, n)
    assert _custom_ops(exported) == {"fps", "ffps", "ball_query", "gather_rows", "nms_keep"}
    served = _round_trip(exported, tmp_path / "fixed.pt2")
    points = _scans(2, n, seed=2)
    _build.reset_launches()
    got = served(points)
    assert set(_build.launches().values()) == {0}  # CPU tensors: the plain versions
    _assert_equal(got, pipe.infer(points))
    with pytest.raises(Exception):  # the batch is part of a fixed artifact
        served(_scans(3, n, seed=2))


def test_attention_grouping_artifact_equals_live(tmp_path):
    """The tiny 3DSSD with attention grouping on SA1 exports with a symbolic
    batch (its ball query reads nothing back to the host), holding one
    attention query node a radius (the query is not chunked on the card),
    and the loaded artifact equals live `infer` bit for bit at batch 1 and
    3."""
    arch = _attention_arch(TINY)
    cfg = load_cfg(str(TINY), ["MODEL.NETWORK.FIRST_STAGE.ARCHITECTURE", str(arch)])
    pipe = build_pipeline(cfg, device="cpu")
    init_weights(pipe.model, 0)
    n = cfg.MODEL.POINTS_NUM_FOR_TRAINING
    exported = export_infer(pipe, 2, n, symbolic_batch=True)
    assert {"ball_query_attention", "nms_keep"} <= _custom_ops(exported)
    queries = [node for node in exported.graph.nodes if node.op == "call_function"
               and str(node.target).startswith("ssd3d.ball_query_attention")]
    assert len(queries) == len(arch[0][2])  # SA1's radii
    served = _round_trip(exported, tmp_path / "attention.pt2")
    for b in (1, 3):
        points = _scans(b, n, seed=5)
        _assert_equal(served(points), pipe.infer(points))


def _attention_arch(path):
    arch = [list(row) for row in load_cfg(str(path)).MODEL.NETWORK.FIRST_STAGE.ARCHITECTURE]
    arch[0][10] = True
    return arch


def test_nuscenes_tiny_artifact_equals_live(tmp_path):
    cfg, pipe = _pipeline(NUSC_TINY)
    n = cfg.MODEL.POINTS_NUM_FOR_TRAINING
    served = _round_trip(export_infer(pipe, 2, n), tmp_path / "nusc.pt2")
    rng = np.random.RandomState(3)
    points = torch.from_numpy(np.concatenate(
        [rng.uniform(-40, 40, (2, n, 3)), rng.uniform(0, 0.5, (2, n, 1))], -1).astype(np.float32))
    got, want = served(points), pipe.infer(points)
    _assert_equal(got, want)
    assert {"velocity", "attribute"} <= set(got)


_LOAD_SIDE = r"""
import sys, torch
import ssd3d_torch.ops
detector = torch.export.load(sys.argv[1]).module()
with torch.inference_mode():
    torch.save([detector(points) for points in torch.load(sys.argv[2])], sys.argv[3])
loaded = sorted(m for m in sys.modules if m.startswith("ssd3d_torch."))
assert not [m for m in loaded if m.split(".")[1] in ("models", "config", "bin", "train")], loaded
print(" ".join(loaded))
"""


def test_cli_symbolic_batch_artifact_loads_with_the_ops_alone(tiny, tmp_path):
    """The CLI exports a port checkpoint with a symbolic batch; a process
    that imports only `ssd3d_torch.ops` serves batches of 1 and 3 with it,
    equal to live `infer`."""
    cfg, pipe, n = tiny
    CheckpointManager(str(tmp_path / "ckpt")).save(
        7, {"step": 7, "model": pipe.model.state_dict(), "optimizer": {}})
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-m", "ssd3d_torch.bin.export", "--cfg", str(TINY),
                          "--log_dir", str(tmp_path), "--symbolic_batch", "--device", "cpu"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    artifact = tmp_path / "detector.pt2"
    meta = json.loads((tmp_path / "detector.pt2.json").read_text())
    assert meta["checkpoint_step"] == 7 and meta["input"] == ["b", n, 4]
    assert meta["device"] == "cpu" and meta["cls_list"] == ["Car"]
    assert meta["bytes"] == artifact.stat().st_size > 0 and meta["cfg"] == str(TINY)

    batches = [_scans(b, n, seed=7) for b in (1, 3)]
    torch.save(batches, tmp_path / "points.pt")
    res = subprocess.run([sys.executable, "-c", _LOAD_SIDE, str(artifact),
                          str(tmp_path / "points.pt"), str(tmp_path / "out.pt")],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "ssd3d_torch.ops.library" in res.stdout.split()
    for got, points in zip(torch.load(tmp_path / "out.pt"), batches, strict=True):
        _assert_equal(got, pipe.infer(points))
        assert got["boxes"].shape == (points.shape[0], 100, 7) and bool(got["valid"].any())
