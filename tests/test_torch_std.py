"""STD (PointRCNN's RPN with the voxelising `PointsPool` RoI pooler): the
port's pooler, the shrunk STD forward, its stage-2 train step and its CLI
chain against the JAX package on the CPU.

Inputs and weights are made with numpy from a seed and handed to both
packages. The shrunk forward is `tests/test_torch_two_stage.py`'s shrunk
PointRCNN with STD's pooler row at a 4 x 4 x 4 grid of 4 points a voxel (as
`tests/test_two_stage.py` shrinks it): the RCNN's SA1 samples 32 of the 64
voxel centres of each proposal, a lattice whose distances tie exactly, so
its D-FPS picks hold only if both packages compute the lattice in the same
order of operations and break ties to the lowest index. The stage-2 step is
`tests/test_torch_two_stage_train.py`'s, with the same pooler row, held to
the JAX step run in float64 (ROADMAP Queue 3 item k).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd3d.config import load_cfg as jax_load_cfg
from ssd3d.models.api import build_pipeline as jax_build_pipeline
from ssd3d.models.two_stage import PointsPool as JaxPointsPool
from ssd3d.models.two_stage import build_two_stage as jax_build_two_stage
from ssd3d.ops import sampling as jsampling
from ssd3d_torch import config
from ssd3d_torch.entry import init_weights, synthetic_scenes
from ssd3d_torch.models.api import build_pipeline
from ssd3d_torch.models.two_stage import PointsPool, build_two_stage
from ssd3d_torch.nn import modules
from ssd3d_torch.train.trainer import CheckpointManager
from ssd3d_torch.utils import synth
from ssd3d_torch.utils.convert import flax_to_state_dict

import test_torch_two_stage as shrunk
import test_torch_two_stage_train as tiny

REPO = Path(__file__).resolve().parents[1]
# the pooler at f32: the same MLPs over the same gathered points, summed in
# another order; held within this share of the output's largest |value|
POOL_RTOL = 1e-5
STD_POOLER = ["PointsPool", ["mask", "dist"], [8], 64, 1.0, [4, 4, 4, 4], [8], True, "roi_pool"]
# the tiny stage-2 config with STD's pooler row (the JAX package's STD
# variant of its CLI test, tests/test_e2e_cli.py)
STD_TINY_POOLER = ("['PointsPool', ['mask', 'dist'], [16], 64, 1.0, [4, 4, 4, 4], [16], True, "
                   "'roi_pool']")
STD_STEP_OPTS = tiny.STEP_OPTS + ["MODEL.NETWORK.FIRST_STAGE.POINTS_POOLER", STD_TINY_POOLER]
# the stage-2 step's losses against the JAX step in float64, as a share of
# the largest loss: the port's f32 losses lie 1.07e-4 from it (the corner
# loss; every other key within 1e-5), the JAX package's own f32 step 5.0e-4
# (the test's recorded properties); PointRCNN's step is held within 1e-4
STD_STEP_LOSS_TOL = 2e-4


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- the pooler

def _pool_inputs(seed: int):
    """Two scans of 400 points around six proposals; proposal 0 of each
    scan has ry = 0 and dyadic coordinates, and 40 points of each scan sit
    exactly on its voxel faces (its expanded box is 4 x 2 x 4 m in a 4 x 4
    x 4 grid: faces every 1, 0.5 and 1 m)."""
    rng = np.random.RandomState(seed)
    bs, n, p, c = 2, 400, 6, 5
    props = np.zeros((bs, p, 7), np.float32)
    props[..., 0] = rng.uniform(-10, 10, (bs, p))
    props[..., 1] = 1.5
    props[..., 2] = rng.uniform(5, 30, (bs, p))
    props[..., 3:6] = [3.0, 1.0, 3.0]
    props[..., 6] = rng.uniform(-3, 3, (bs, p))
    props[:, 0] = [2.0, 1.5, 12.0, 3.0, 1.0, 3.0, 0.0]
    pts = (rng.uniform(-2, 2, (bs, n, 3)) + props[:, rng.randint(0, p, n), :3]).astype(np.float32)
    faces = np.stack([rng.randint(-2, 3, (bs, 40)) * 1.0, -rng.randint(0, 5, (bs, 40)) * 0.5,
                      rng.randint(-2, 3, (bs, 40)) * 1.0], -1)
    pts[:, :40] = props[:, :1, :3] + faces
    feats = rng.randn(bs, n, c).astype(np.float32)
    mask = (rng.rand(bs, n, 1) > 0.5).astype(np.float32)
    return pts, feats, mask, props


@pytest.mark.parametrize("train,grid", [(False, 4), (True, 4), (False, 6)])
def test_points_pool_matches_jax(train, grid):
    """From converted weights: voxel centres bit for bit (at STD's grid of
    6 too, where a division by 6 and a product with its reciprocal round
    apart), pooled features within POOL_RTOL of the largest, `has` equal;
    in train mode (batch statistics) the moved running statistics too."""
    pts, feats, mask, props = _pool_inputs(3)
    jpool = JaxPointsPool(sample_pts_num=32, context_range=1.0, info_keys=("mask", "dist"),
                          align_channels=(8,), grid=(grid, grid, grid, 4), vfe_channels=(8, 12),
                          bn=True)
    args = [jnp.asarray(a) for a in (pts, feats, mask, props)]
    shapes = jax.eval_shape(lambda *a: jpool.init(jax.random.PRNGKey(0), *a, False), *args)
    variables = shrunk._fill(shapes, 4)
    if train:
        (want, want_has), moved = jpool.apply(variables, *args, True, 0.9,
                                              mutable=["batch_stats"])
    else:
        want, want_has = jpool.apply(variables, *args, False)
    pool = PointsPool(5, 32, 1.0, ["mask", "dist"], [8], [grid, grid, grid, 4], [8, 12], bn=True)
    pool.load_state_dict(flax_to_state_dict(variables), strict=True)
    pool.train(train)
    got, has = pool(*[_t(a) for a in (pts, feats, mask, props)], 0.9)
    want = np.asarray(want)
    assert got.shape == want.shape == (2 * 6, grid ** 3, 3 + 12)
    np.testing.assert_array_equal(has.numpy(), np.asarray(want_has))
    np.testing.assert_array_equal(got[..., :3].detach().numpy(), want[..., :3])
    shrunk._close(got.detach().numpy(), want, POOL_RTOL, "pooled")
    # empty voxels are zero, and proposal 0's face points fill several voxels
    filled = (np.abs(want[..., 3:]).sum(-1) > 0)
    assert 0 < filled.mean() < 1 and filled[0].sum() >= 8
    if train:
        for key, value in flax_to_state_dict({"batch_stats": moved["batch_stats"]}).items():
            shrunk._close(dict(pool.named_buffers())[key].numpy(), value.numpy(), POOL_RTOL, key)


def test_points_pool_voxel_ids_on_faces_match_jax():
    """A point on a voxel face goes to the voxel the JAX package puts it in:
    (canonical / size + 0.5) * g (+ 1.0 for y), truncated, then clamped."""
    pool = PointsPool(1, 8, 1.0, [], [4], [4, 4, 4, 4], [4], bn=False)
    size = np.array([[[4.0, 2.0, 4.0]]], np.float32)
    coords = np.array([-2.0, -1.5, -1.0, -0.5, 0.0, 0.5, 1.0, 1.5, 2.0, 2.5, -2.5], np.float32)
    canon = np.stack(np.meshgrid(coords, coords / 2.0 - 1.0, coords, indexing="ij"), -1)
    canon = canon.reshape(1, 1, -1, 3).astype(np.float32)
    got = pool.voxel_ids(_t(canon), _t(size)).numpy()
    gl = gh = gw = 4
    c, s = jnp.asarray(canon), jnp.asarray(size)
    fx = (c[..., 0] / s[..., None, 0] + 0.5) * gl
    fy = (c[..., 1] / s[..., None, 1] + 1.0) * gh
    fz = (c[..., 2] / s[..., None, 2] + 0.5) * gw
    vx = jnp.clip(fx.astype(jnp.int32), 0, gl - 1)
    vy = jnp.clip(fy.astype(jnp.int32), 0, gh - 1)
    vz = jnp.clip(fz.astype(jnp.int32), 0, gw - 1)
    np.testing.assert_array_equal(got, np.asarray((vx * gh + vy) * gw + vz))
    assert len(np.unique(got)) == gl * gh * gw


def test_std_configs_build_with_the_points_pool():
    """Both shipped STD YAMLs load and build: the pooler's row gives the
    grid and the VFE widths, and the RCNN takes 3 + vfe[-1] channels."""
    for name in ("std.yaml", "std_stage2.yaml"):
        cfg = config.load_cfg(str(REPO / "configs/kitti/std" / name))
        model, _, _ = build_two_stage(cfg, device="cpu")
        pool = model.roi_pool
        assert isinstance(pool, PointsPool) and pool.grid == (6, 6, 6, 10)
        assert pool.out_channels == 3 + 128
        # SA1's MLP takes the pooled features and the grouped xyz
        assert model.rcnn_backbone.rcnn_layer1.mlp0.conv0.conv.kernel.shape[0] == 128 + 3


# ------------------------------------------------------- the shrunk STD

PRE_TOPK = shrunk.PRE_TOPK


@pytest.fixture(scope="module")
def std_run():
    """(cfg, flax variables, scans, JAX detections, the port's pipeline)
    for the shrunk STD at batch 2 x 32 proposals."""
    cfg = shrunk._shrunk_cfg()
    cfg.MODEL.NETWORK.FIRST_STAGE.POINTS_POOLER = list(STD_POOLER)
    points = shrunk._scans(np.random.RandomState(0))
    jmodel, rpn_spec, _ = jax_build_two_stage(cfg, nms_pre_topk=PRE_TOPK)
    shapes = jax.eval_shape(lambda p: jmodel.init(jax.random.PRNGKey(0), p, False, 0.9,
                                                  rpn_spec=rpn_spec), jnp.asarray(points))
    variables = shrunk._fill(shapes, 5)
    want = jax.jit(jax_build_pipeline(cfg, nms_pre_topk=PRE_TOPK).infer)(
        variables, jnp.asarray(points))
    pipe = build_pipeline(cfg, nms_pre_topk=PRE_TOPK, device="cpu")
    pipe.model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return cfg, variables, points, {k: np.asarray(v) for k, v in want.items()}, pipe


def test_std_flax_tree_loads_strictly(std_run):
    _, variables, _, _, pipe = std_run
    sd = flax_to_state_dict(variables)
    assert len(sd) == len(jax.tree_util.tree_leaves(variables))
    missing, unexpected = pipe.model.load_state_dict(sd, strict=False)
    assert missing == [] and unexpected == []
    assert {k.split(".")[0] for k in sd} == {"rpn_backbone", "rpn_head", "roi_pool",
                                           "rcnn_backbone", "rcnn_head"}
    assert "roi_pool.align.conv0.conv.kernel" in sd and "roi_pool.vfe.conv0.bn.mean" in sd


def test_shrunk_std_matches_jax(std_run):
    """The RCNN's D-FPS picks over the voxel lattice equal the JAX
    package's on the same centres; proposals, boxes and scores within 1e-4
    of the largest |value| (tests/test_torch_two_stage.py's tolerance);
    keep sets, classes and indices equal."""
    _, _, points, want, pipe = std_run
    calls = []
    orig = modules.farthest_point_sample

    def recording(xyz, npoint):
        out = orig(xyz, npoint)
        calls.append((xyz.clone(), npoint, out))
        return out

    modules.farthest_point_sample = recording
    try:
        got = {k: v.numpy() for k, v in pipe.infer(_t(points)).items()}
    finally:
        modules.farthest_point_sample = orig
    rcnn = [(xyz, m, out) for xyz, m, out in calls if xyz.shape[0] == 64]
    assert [(tuple(x.shape), m) for x, m, _ in rcnn] == [((64, 64, 3), 32), ((64, 32, 3), 8)]
    # the lattice ties: most picks are one of several equally far centres
    assert _tied_picks(rcnn[0][0], 32) > 64 * 31 // 2
    for xyz, m, out in rcnn:
        np.testing.assert_array_equal(
            out.numpy(), np.asarray(jsampling.farthest_point_sample(jnp.asarray(xyz), m)))
    assert set(got) == set(want)
    for key in ("proposals_valid", "valid", "classes", "index"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    shrunk._close(got["proposals"], want["proposals"], what="proposals")
    shrunk._close(got["boxes"], want["boxes"], what="boxes")
    shrunk._close(got["scores"], want["scores"], what="scores")
    assert got["proposals_valid"].sum() > 8 and got["valid"].sum() > 0


def _tied_picks(xyz: torch.Tensor, m: int) -> int:
    """How many of the D-FPS picks 1..m-1 over clouds xyz [b, n, 3] were a
    tie: the running minimum's largest value held by more than one point."""
    x, y, z = xyz.unbind(-1)
    dist = torch.full(x.shape, float("inf"))
    last = torch.zeros(x.shape[0], 1, dtype=torch.int64)
    tied = 0
    for _ in range(1, m):
        dx, dy, dz = x - x.gather(1, last), y - y.gather(1, last), z - z.gather(1, last)
        dist = torch.minimum(dist, (dx * dx + dy * dy) + dz * dz)
        tied += int(((dist == dist.amax(1, keepdim=True)).sum(1) > 1).sum())
        last = dist.argmax(1, keepdim=True)
    return tied


# ------------------------------------------------------ the stage-2 step

@pytest.fixture(scope="module")
def std_step():
    """One f32 stage-2 step of the tiny STD config in both packages from
    the same seeded state and batch (`tiny.stage_run`)."""
    return tiny.stage_run(2, synthetic_scenes(tiny.BATCH, 2048, seed=5), STD_STEP_OPTS,
                          f32_lattice=True)


def test_std_stage2_step_losses_match_jax(std_step, record_property):
    tiny.check_step_losses(std_step, 2, record_property, STD_STEP_LOSS_TOL)


def test_std_stage2_step_state_matches_jax(std_step):
    """The state after the step leaf by leaf, the frozen RPN bit for bit,
    and the pooler's `align` and `vfe` among the trained parameters."""
    tiny.check_step_state(std_step, 2)
    trained = {k[3:] for k in std_step["after"] if k.startswith("mu:")}
    assert any(k.startswith("roi_pool.vfe.") for k in trained)
    assert any(k.startswith("roi_pool.align.") for k in trained)


# ------------------------------------------------------- the CLI chain

def test_cli_std_stagewise(tmp_path):
    """The port's twin of the STD variant of
    tests/test_e2e_cli.py::test_cli_pointrcnn_stagewise: stage 1 (the RPN),
    then the tiny stage 2 with STD's pooler row warm-started from it, the
    RPN bit for bit stage 1's, the pooler trained, then `bin.evaluate` of
    the STD run."""
    data, npz = tmp_path / "kitti", tmp_path / "npz"
    run1, run3 = tmp_path / "run_stage1", tmp_path / "run_std"
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
    cfg1 = "configs/kitti/pointrcnn/pointrcnn_tiny_stage1.yaml"
    cfg2 = "configs/kitti/pointrcnn/pointrcnn_tiny_stage2.yaml"
    std_opts = opts + ["MODEL.NETWORK.FIRST_STAGE.POINTS_POOLER", STD_TINY_POOLER]
    for split in ("train", "val"):
        _run("ssd3d_torch.bin.preprocess", ["--cfg", cfg1, "--img_list", split] + opts)
    _run("ssd3d_torch.bin.train", ["--cfg", cfg1, "--log_dir", str(run1)] + opts)
    _run("ssd3d_torch.bin.train", ["--cfg", cfg2, "--log_dir", str(run3),
                                   "--restore_model_path", str(run1)] + std_opts)
    assert "warm start from" in (run3 / "log_train.txt").read_text()
    metrics = [json.loads(line) for line in open(run3 / "metrics.jsonl")]
    assert [m["iter"] for m in metrics] == [1, 2, 3, 4]
    assert all(np.isfinite(m["total"]) and m["total"] > 0 for m in metrics)
    ckpt1 = CheckpointManager(str(run1 / "ckpt")).restore()[0]["model"]
    ckpt3 = CheckpointManager(str(run3 / "ckpt")).restore()[0]["model"]
    rpn = [k for k in ckpt1 if k.startswith("rpn") and not k.endswith((".mean", ".var"))]
    assert rpn and all(torch.equal(ckpt1[k], ckpt3[k]) for k in rpn)
    vfe = [k for k in ckpt3 if k.startswith("roi_pool.vfe.") and k.endswith("kernel")]
    assert vfe and not any(k in ckpt1 for k in vfe)  # stage 1 has RegionPool's scopes only
    # the pooler started where the trainer's seeded init put it
    pipe = build_pipeline(config.load_cfg(cfg2, std_opts[2:]), device="cpu")
    init_weights(pipe.model, 0)
    start = pipe.model.state_dict()
    assert any((ckpt3[k] - start[k]).abs().max() > 1e-6 for k in vfe), "the VFE did not train"
    _run("ssd3d_torch.bin.evaluate", ["--cfg", cfg2, "--log_dir", str(run3), "--once",
                                      "--cls_threshold", "0.01"] + std_opts)
    final = json.load(open(run3 / "eval_4.json"))
    assert final["total"] > 0 and np.isfinite(final["recall"])


def _run(module, argv):
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    p = subprocess.run([sys.executable, "-m", module] + argv, capture_output=True, text=True,
                       cwd=REPO, env=env, timeout=300)
    assert p.returncode == 0, (f"{module} failed rc={p.returncode}\n--- stdout\n"
                               f"{p.stdout[-1500:]}\n--- stderr\n{p.stderr[-1500:]}")
    return p
