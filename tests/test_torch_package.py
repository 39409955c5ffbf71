"""Package-level checks of the PyTorch port: it imports nothing of JAX and
nothing of the JAX package (`ssd3d`, `tools`), its entry point runs on the
CPU when asked to, its kernel build is keyed by its sources, and
`chip_smoke.py` refuses to report a result without a GPU."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]

_NO_JAX = r"""
import importlib, importlib.abc, pkgutil, sys

REFUSED = ("jax", "jaxlib", "flax", "ssd3d", "tools")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"{name} imported by the port")
        return None

for mod in [m for m in sys.modules if m.split(".")[0] in REFUSED]:
    del sys.modules[mod]
sys.meta_path.insert(0, Refuse())
import ssd3d_torch
names = [m.name for m in pkgutil.walk_packages(ssd3d_torch.__path__, "ssd3d_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = [m for m in sys.modules if m.split(".")[0] in REFUSED]
assert not bad, bad
print(" ".join(names))
"""


def _run(args, cwd, **kw):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=120, **kw)


def test_port_and_chip_smoke_import_without_jax():
    res = _run(["-c", _NO_JAX], REPO)
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    assert len(names) >= 40  # every module of the package
    assert {f"ssd3d_torch.bin.{m}" for m in ("preprocess", "train", "evaluate", "test")} <= names
    assert {f"ssd3d_torch.data.{m}" for m in ("kitti_io", "augment", "preprocess", "loader")} <= names
    assert {"ssd3d_torch.data.nuscenes", "ssd3d_torch.eval.nuscenes_eval",
            "ssd3d_torch.eval.nuscenes_predictions", "ssd3d_torch.utils.synth_nuscenes"} <= names
    assert {"ssd3d_torch.eval.kitti_ap", "ssd3d_torch.eval.predictions", "ssd3d_torch.native",
            "ssd3d_torch.train.trainer", "ssd3d_torch.train.two_stage_step",
            "ssd3d_torch.utils.viz", "ssd3d_torch.train.adabound",
            "ssd3d_torch.train.device_aug"} <= names
    assert {"ssd3d_torch.parallel.distributed", "ssd3d_torch.parallel.data_parallel",
            "ssd3d_torch.parallel.steps"} <= names
    assert {"ssd3d_torch.ops.library", "ssd3d_torch.bin.export", "ssd3d_torch.utils.tf_bundle",
            "ssd3d_torch.utils.tf_checkpoint", "ssd3d_torch.utils.profiling"} <= names


def test_entry_runs_the_flagship_on_a_cpu_scan():
    from ssd3d_torch.entry import entry
    from ssd3d_torch.ops import _build

    _build.reset_launches()
    fn, (points,) = entry(device="cpu")
    assert points.shape == (1, 16384, 4)
    det = fn(points)
    assert det["boxes"].shape == (1, 100, 7) and det["valid"].shape == (1, 100)
    assert torch.isfinite(det["boxes"]).all() and torch.isfinite(det["scores"]).all()
    assert 0 < int(det["valid"].sum()) <= 100
    assert set(_build.launches().values()) == {0}  # CPU tensors: plain versions only


def test_kernel_library_is_keyed_by_its_sources(monkeypatch, tmp_path):
    from ssd3d_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    first = _build.library_path()
    assert first.parent == _build.BUILD_DIR and first.suffix == ".so"
    with open(csrc / "gather.cu", "a") as f:
        f.write("\n// changed\n")
    assert _build.library_path() != first


def test_each_kernel_source_names_the_tpu_kernel_it_replaces():
    for name, pallas in [("fps.cu", "fps.py:_fps_batch_kernel"),
                         ("ffps.cu", "fps.py:_ffps_hbm_kernel"),
                         ("ffps_dist.cu", "fps.py:_ffps_kernel"),
                         ("ffps_dist.cu", "fps.py:_ffps_hbm_kernel"),
                         ("ball_query.cu", "ring_words.py:_kernel"),
                         ("gather.cu", "gather.py:_kernel"),
                         ("scatter_add.cu", "scatter_add.py:_scatter_add_raw"),
                         ("scatter_add.cu", "gather.py:_gather_bwd"),
                         ("three_nn.cu", "three_nn.py:_three_nn_kernel"),
                         ("sa_fused.cu", "sa_fused.py:_kernel_multi"),
                         ("sa_fused.cu", "sa_fused.py:_kernel")]:
        head = (REPO / "ssd3d_torch" / "csrc" / name).read_text()[:1500]
        assert "ssd3d/ops/pallas/" + pallas.split(":")[0] in head, name
        assert pallas.split(":")[1] in head, name
        assert "bounds it on the H100" in head, name


def test_each_custom_op_names_its_source_and_the_tpu_kernels_it_replaces():
    """Every kernel is one custom op (`ops/library.py`), whose entry names
    its CUDA source and the `pl.pallas_call` functions that source
    replaces; each such function exists in the JAX package's Pallas file.
    K8, K9 and K10 name the JAX package's XLA code they stand for instead,
    by a path from the repository root: a `fori_loop` line, the function's
    definition, or the conv application that XLA fuses with its BatchNorm
    and ReLU (K10)."""
    from ssd3d_torch.ops import library

    sources = set()
    for op, (source, replaced) in library.OPS.items():
        head = (REPO / "ssd3d_torch" / "csrc" / source).read_text()[:1500]
        sources.add(source)
        for site in replaced:
            file, where = site.split(":")
            if "/" in file:  # a line of XLA code
                assert "Replaces no Pallas kernel" in head and "bounds it on the H100" in head, op
                text = (REPO / file).read_text().splitlines()[int(where) - 1]
                assert ("fori_loop" in text or f"def {op}(" in text
                        or "_dense_apply(" in text), site
            else:  # a Pallas function
                text = (REPO / "ssd3d" / "ops" / "pallas" / file).read_text()
                assert f"def {where}(" in text, site
        assert getattr(torch.ops.ssd3d, op).default._schema.name == f"ssd3d::{op}"
    assert sources == {p.name for p in (REPO / "ssd3d_torch" / "csrc").glob("*.cu")}


def test_chip_smoke_fails_without_a_gpu():
    assert not torch.cuda.is_available()
    res = _run([str(REPO / "chip_smoke.py")], REPO)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
