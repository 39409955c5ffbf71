"""The port's trainer (`ssd3d_torch/train/trainer.py`): `torch.save`
checkpoints (rotation, atomic saves, the daemon's refreshed listing, every
path shape of `restore_from_path`, name-and-shape warm starts), exact resume
on the CPU, and the port's `Trainer` against the JAX package's on the tiny
3DSSD config at f32, on the same tree of scans.

The two trainers are compared iteration by iteration from the same state:
iteration 1 from the JAX trainer's initial flax tree, converted and handed
to the port as a warm start; iterations 2 and 3 from the JAX trainer's own
state before them (parameters, BatchNorm statistics, Adam's moments and
count), converted into a port checkpoint that the port's trainer resumes
from. After each iteration the port's checkpoint is held to the JAX
trainer's next state leaf by leaf: step and Adam's count equal, BatchNorm
statistics, Adam's moments and the parameters within the tolerances below.

The trajectories are not compared free-running: Adam's first update is
lr * g / (|g| + 1e-8), about lr * sign(g), and every bias that a BatchNorm
follows (whose exact gradient is 0) has a gradient at f32 rounding level,
whose sign the two frameworks draw differently. Run free from the same
initial tree, the totals part by 6.7e-6, 1.5e-2 and 6.0e-2 (relative) at
iterations 1, 2 and 3 (recorded as `free_running_total_rel_diff`), while
each iteration from a shared state stays within 1e-4."""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import optax
import pytest
import torch

from ssd3d import config as jconfig
from ssd3d.train.trainer import Trainer as JaxTrainer
from ssd3d_torch import config
from ssd3d_torch.data.loader import KittiLoader
from ssd3d_torch.data.preprocess import run_preprocess
from ssd3d_torch.entry import synthetic_scenes
from ssd3d_torch.models.single_stage import build_detector
from ssd3d_torch.train import trainer as trainer_mod
from ssd3d_torch.train.train_step import TrainGraph
from ssd3d_torch.train.trainer import (
    CheckpointManager,
    Trainer,
    checkpoint_of,
    load_checkpoint,
    merge_by_name,
    restore_from_path,
)
from ssd3d_torch.utils import synth
from ssd3d_torch.utils.convert import flax_to_state_dict

REPO = Path(__file__).resolve().parents[1]
TINY = str(REPO / "configs/kitti/3dssd/3dssd_tiny.yaml")
# totals of one f32 iteration, port against JAX, from the same state: sums
# over a few thousand points in another order
TOTAL_RTOL = 1e-4
# the state after one iteration, port against JAX, from the same state.
# BatchNorm running statistics, relative to the leaf's largest |value|
# (measured <= 7.1e-6).
STAT_RTOL = 1e-4
# A leaf whose largest |gradient| is at most this share of the largest of all
# leaves is at rounding level (measured: <= 1.9e-5 for Dense biases that a
# BatchNorm follows; >= 1.3e-4, or exactly 0, for every other leaf).
ROUNDING_LEVEL = 5e-5
# Adam's moments, |port - JAX| over |JAX| in norm, leaf by leaf, at
# iterations 1, 2 and 3. Iteration 1 starts from the initial tree: there the
# gradients of layer4 (the SA layer over the vote centres) part by up to 1.4%
# in norm (every other leaf <= 0.2%); from iteration 2 on every leaf is
# within 2.4e-4 (measured).
MOMENT_RTOL = (2e-2, 1e-3, 1e-3)
# Parameters: entries whose gradient is at least this share of their leaf's
# largest, so that its sign is resolved, within PARAM_TOL * lr of JAX's
# (measured <= 8.2e-4 * lr).
RESOLVED = 0.1
PARAM_TOL = 1e-2
TIMES = ("sec_per_it", "loader_wait_s")


def _opts(root: Path, **over) -> list[str]:
    data = root / "kitti"
    opts = {"DATASET.KITTI.BASE_DIR_PATH": str(data),
            "DATASET.KITTI.TRAIN_LIST": str(data / "train.txt"),
            "DATASET.KITTI.VAL_LIST": str(data / "val.txt"),
            "DATASET.KITTI.SAVE_NUMPY_PATH": str(root / "npz"),
            "TRAIN.CONFIG.BATCH_SIZE": "2", "TRAIN.CONFIG.MAX_ITERATIONS": "4",
            "TRAIN.CONFIG.CHECKPOINT_INTERVAL": "2", "TRAIN.CONFIG.SUMMARY_INTERVAL": "1",
            "TRAIN.CONFIG.SUMMARY_BEV_IMAGES": "False", "TRAIN.AUGMENTATIONS.MIXUP.NUMBER": "(3, )",
            "DATA_LOADER.NUM_PROCS": "0", **over}
    return [x for kv in opts.items() for x in kv]


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """Four synthetic training scans, preprocessed (npz and mixup crops)."""
    root = tmp_path_factory.mktemp("train")
    synth.write_tree(str(root / "kitti"), n_train=4, n_val=1, n_points=2600, seed=3, k_max=3)
    run_preprocess(config.load_cfg(TINY, _opts(root)), "train", log=lambda *a: None)
    return root


def _metrics(run: Path) -> list[dict]:
    return [json.loads(line) for line in open(run / "metrics.jsonl")]


def _tiny_graph(seed=0):
    """The tiny config's detector at f32 with seeded weights -> (graph,
    fresh train state)."""
    cfg = config.load_cfg(TINY, ["TPU.COMPUTE_DTYPE", "float32"])
    model, spec = build_detector(cfg, device="cpu")
    trainer_mod.init_weights(model, seed)
    graph = TrainGraph.build(cfg, model, spec)
    return graph, graph.init_state()


# ------------------------------------------------------------ checkpoints

def _ckpt(step, value=0.0):
    return {"step": step, "model": {"w": torch.full((2, 2), float(value))}}


def test_checkpoint_manager_rotates_past_max_to_keep(tmp_path):
    mngr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=3)
    assert mngr.all_steps() == [] and mngr.latest_step() is None
    assert mngr.restore() == (None, None)
    for step in (10, 20, 30, 40, 50):
        mngr.save(step, _ckpt(step, step))
    assert mngr.all_steps() == [30, 40, 50] and mngr.latest_step() == 50
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["30", "40", "50"]  # no temporaries left
    ckpt, step = mngr.restore(40)
    assert step == 40 and torch.equal(ckpt["model"]["w"], torch.full((2, 2), 40.0))


def test_all_steps_refresh_sees_saves_of_another_manager(tmp_path):
    """The evaluate daemon's view, made before the trainer's first save."""
    watcher = CheckpointManager(str(tmp_path / "ckpt"))
    assert watcher.all_steps(refresh=True) == []
    CheckpointManager(str(tmp_path / "ckpt")).save(10, _ckpt(10))
    assert watcher.all_steps(refresh=True) == [10]


def test_a_half_written_checkpoint_is_never_listed(tmp_path, monkeypatch):
    mngr = CheckpointManager(str(tmp_path / "ckpt"))
    mngr.save(10, _ckpt(10))

    def dies(obj, path):
        Path(path).write_bytes(b"half")
        raise OSError("disk full")

    monkeypatch.setattr(trainer_mod.torch, "save", dies)
    with pytest.raises(OSError, match="disk full"):
        mngr.save(20, _ckpt(20))
    (tmp_path / "ckpt" / "30").mkdir()  # a step directory without its state file
    assert mngr.all_steps() == [10] and mngr.latest_step() == 10


def test_restore_from_path_accepts_all_path_shapes(tmp_path):
    """--restore_model_path takes a run dir, its ckpt dir, a numeric step
    dir and a copied-aside step dir (best_ckpt)."""
    run = tmp_path / "run"
    CheckpointManager(str(run / "ckpt")).save(40, _ckpt(40, 7.0))
    shutil.copytree(run / "ckpt" / "40", run / "best_ckpt")
    for path in (run, run / "ckpt", run / "ckpt" / "40", run / "best_ckpt"):
        ckpt, step = restore_from_path(str(path))
        assert step == 40, path
        assert torch.equal(ckpt["model"]["w"], torch.full((2, 2), 7.0))
    with pytest.raises(FileNotFoundError, match="not found"):
        restore_from_path(str(tmp_path / "nope"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="neither"):
        restore_from_path(str(tmp_path / "empty"))


def test_merge_by_name_intersects_keys_and_shapes():
    dst = {"rpn.w": torch.zeros(3, 2), "rpn.b": torch.zeros(2), "rcnn.w": torch.zeros(4, 4),
           "extra.v": torch.zeros(5, dtype=torch.float64)}
    src = {"rpn.w": torch.ones(3, 2), "rpn.b": torch.ones(7),  # b: another shape
           "rcnn.w": torch.full((4, 4), 2.0), "stale.q": torch.ones(1),  # q: not in dst
           "extra.v": torch.ones(5)}
    merged, copied, skipped = merge_by_name(dst, src)
    assert sorted(copied) == ["extra.v", "rcnn.w", "rpn.w"]
    assert skipped == ["rpn.b"]
    assert torch.equal(merged["rpn.w"], torch.ones(3, 2))
    assert torch.equal(merged["rpn.b"], torch.zeros(2))  # left at init
    assert merged["extra.v"].dtype == torch.float64  # dtype follows the destination
    assert torch.equal(dst["rpn.w"], torch.zeros(3, 2))  # dst itself untouched


def test_checkpoint_holds_the_whole_train_state_on_the_cpu(tmp_path):
    """A checkpoint taken after one step restores parameters, BatchNorm
    statistics, Adam's moments and count and the step: the next step from
    the restored state equals the next step of the original bit for bit."""
    batch = {k: torch.from_numpy(v) for k, v in synthetic_scenes(2, 2048, seed=1).items()}
    graph_a, a = _tiny_graph()
    graph_a.train_step(a, batch)
    mngr = CheckpointManager(str(tmp_path / "ckpt"))
    mngr.save(a.step, checkpoint_of(a))
    ckpt, step = mngr.restore()
    assert step == 1 and ckpt["step"] == 1
    flat = [t for t in ckpt["model"].values()]
    flat += [t for s in ckpt["optimizer"]["state"].values() for t in s.values()]
    assert flat and all(t.device.type == "cpu" for t in flat)
    assert ckpt["optimizer"]["param_groups"][0]["count"] == 1
    assert any(k.endswith(".mean") for k in ckpt["model"])
    graph_b, b = _tiny_graph(seed=5)  # other weights, fresh optimizer
    load_checkpoint(b, ckpt)
    ma, mb = graph_a.train_step(a, batch), graph_b.train_step(b, batch)
    assert {k: float(v) for k, v in ma.items()} == {k: float(v) for k, v in mb.items()}
    for (name, pa), pb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(pa, pb), name


# ----------------------------------------------------------------- trainer

def test_trainer_resumes_exactly_on_the_cpu(scans, tmp_path):
    """An unbroken run of 4 iterations and one stopped at its step-2
    checkpoint and resumed by a new Trainer log the same values and end with
    the same checkpoint, bit for bit."""
    cfg = config.load_cfg(TINY, _opts(scans))
    Trainer(cfg, str(tmp_path / "a"), device="cpu").train()
    Trainer(config.load_cfg(TINY, _opts(scans)), str(tmp_path / "b"), device="cpu").train(2)
    Trainer(config.load_cfg(TINY, _opts(scans)), str(tmp_path / "b"), device="cpu").train()
    assert "restored checkpoint at step 2" in (tmp_path / "b" / "log_train.txt").read_text()
    a, b = _metrics(tmp_path / "a"), _metrics(tmp_path / "b")
    assert [m["iter"] for m in a] == [m["iter"] for m in b] == [1, 2, 3, 4]
    for ma, mb in zip(a, b):
        assert {k: v for k, v in ma.items() if k not in TIMES} == \
            {k: v for k, v in mb.items() if k not in TIMES}
    assert len({m["total"] for m in a}) == 4  # the runs did move
    ca, _ = CheckpointManager(str(tmp_path / "a" / "ckpt")).restore(4)
    cb, _ = CheckpointManager(str(tmp_path / "b" / "ckpt")).restore(4)
    for k in ca["model"]:
        assert torch.equal(ca["model"][k], cb["model"][k]), k
    for i, s in ca["optimizer"]["state"].items():
        for k in s:
            assert torch.equal(s[k], cb["optimizer"]["state"][i][k]), (i, k)
    assert ca["optimizer"]["param_groups"] == cb["optimizer"]["param_groups"]
    assert CheckpointManager(str(tmp_path / "a" / "ckpt")).all_steps() == [2, 4]


def test_trainer_asks_for_worker_processes_that_do_not_fork_on_the_card(scans, tmp_path,
                                                                          monkeypatch):
    cfg = config.load_cfg(TINY, _opts(scans, **{"DATA_LOADER.NUM_PROCS": "-1",
                                                "TRAIN.CONFIG.MAX_ITERATIONS": "1"}))
    trainer = Trainer(cfg, str(tmp_path / "run"), device="cpu")
    asked = []
    real_batches = KittiLoader.batches

    def batches(self, *args, **kw):
        asked.append((kw["num_procs"], kw["mp_method"]))
        return real_batches(self, *args, **kw)

    monkeypatch.setattr(KittiLoader, "batches", batches)
    trainer.train()
    # the host augments: 4 worker processes, started as on the card
    assert asked == [(4, "forkserver")]
    assert "4 worker processes started by forkserver" in \
        (tmp_path / "run" / "log_train.txt").read_text()


def test_trainer_names_what_is_not_ported(scans, tmp_path):
    opts = _opts(scans)
    # fsdp is ported (tests/test_torch_distributed.py); in a single process,
    # without a process group, there is nothing to shard and the step is plain
    single = Trainer(config.load_cfg(TINY, opts + ["TPU.PARALLEL_MODE", "fsdp"]),
                     str(tmp_path / "fsdp"), device="cpu")
    assert single.parallel is None and single.world == 1 and single.is_lead
    with pytest.raises(ValueError, match="unknown TPU.PARALLEL_MODE"):
        Trainer(config.load_cfg(TINY, opts + ["TPU.PARALLEL_MODE", "zero"]), str(tmp_path),
                device="cpu")
    # reference TF checkpoints are ported (tests/test_torch_tf_checkpoint.py):
    # a path that holds none is refused, with the path, when the run starts
    absent = str(tmp_path / "no_tf_ckpt")
    with pytest.raises(FileNotFoundError, match="no checkpoint at"):
        Trainer(config.load_cfg(TINY, opts), str(tmp_path / "tf"), restore_tf_checkpoint=absent,
                device="cpu").init_or_restore()
    # PointRCNN's stage 2 is ported: the trainer builds the two-stage graph
    # the JAX package's trainer builds, and its optimizer holds only the
    # RCNN's parameters (TRAIN_PARAM_PREFIX rcnn, roi)
    stage2 = str(REPO / "configs/kitti/pointrcnn/pointrcnn_tiny_stage2.yaml")
    rcnn = Trainer(config.load_cfg(stage2, opts), str(tmp_path / "rcnn"), device="cpu")
    want = JaxTrainer(jconfig.load_cfg(stage2, opts), str(tmp_path / "jax_rcnn")).graph
    got = rcnn.graph
    for field in ("only_first_stage", "minibatch", "pool_context", "pool_mask_thresh",
                  "loss_prefixes", "freeze_rpn"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.assigner_2.pos_iou == want.assigner_2.pos_iou and got.assigner_2.method == "IoU"
    trained = {id(p) for p in rcnn.init_or_restore().optimizer.param_groups[0]["params"]}
    names = [n for n, p in got.model.named_parameters() if id(p) in trained]
    assert names and all(n.startswith(("rcnn", "roi")) for n in names)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(config.load_cfg(TINY, opts), str(tmp_path))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_checkpoint(jstate, names, group) -> dict:
    """A JAX TrainState -> the port's checkpoint: parameters and BatchNorm
    statistics, Adam's moments and count (optax's ScaleByAdamState) and
    the step."""
    adam = [s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1
    mu = flax_to_state_dict({"params": _np_tree(adam[0].mu)})
    nu = flax_to_state_dict({"params": _np_tree(adam[0].nu)})
    return {"step": int(jstate.step),
            "model": flax_to_state_dict({"params": _np_tree(jstate.params),
                                         "batch_stats": _np_tree(jstate.batch_stats)}),
            "optimizer": {"state": {i: {"mu": mu[n], "nu": nu[n]} for i, n in enumerate(names)},
                          "param_groups": [dict(group, count=int(adam[0].count))]}}


def _leaves(ckpt: dict, names: list[str]) -> dict:
    """A port checkpoint -> {leaf name: tensor}: parameters and BatchNorm
    statistics, Adam's moments as `mu:<name>` and `nu:<name>`."""
    out = dict(ckpt["model"])
    for i, name in enumerate(names):
        for moment in ("mu", "nu"):
            out[f"{moment}:{name}"] = ckpt["optimizer"]["state"][i][moment]
    return out


def test_trainer_iterations_match_the_jax_trainer(scans, tmp_path, monkeypatch,
                                                  record_property):
    opts = _opts(scans, **{"TRAIN.CONFIG.MAX_ITERATIONS": "3",
                           "TRAIN.CONFIG.CHECKPOINT_INTERVAL": "1",
                           "TPU.COMPUTE_DTYPE": "float32"})
    # the JAX trainer on one device, its state recorded before and after
    # each step
    states, after = [], []
    real_build = JaxTrainer._build_step_fn

    def build(self, state):
        real_build(self, state)
        step_fn = self.step_fn

        def step(state, batch, rng):
            states.append(jax.device_get(state))
            out = step_fn(state, batch, rng)
            after.append(jax.device_get(out[0]))
            return out

        self.step_fn = step

    real_devices = jax.devices
    monkeypatch.setattr(JaxTrainer, "_build_step_fn", build)
    with mock.patch.object(jax, "devices", lambda *a, **k: real_devices(*a, **k)[:1]):
        JaxTrainer(jconfig.load_cfg(TINY, opts), str(tmp_path / "jax"), seed=0).train()
    want = _metrics(tmp_path / "jax")
    assert [m["iter"] for m in want] == [1, 2, 3] and len(states) == len(after) == 3

    _, template = _tiny_graph()
    names = [n for n, _ in template.model.named_parameters()]
    group = {k: v for k, v in template.optimizer.state_dict()["param_groups"][0].items()}
    got, post = [], []
    # iteration 1: a warm start from the JAX trainer's initial tree, run on
    # free for all 3 iterations
    init = tmp_path / "init"
    CheckpointManager(str(init / "ckpt")).save(
        0, {"step": 0, "model": _port_checkpoint(states[0], names, group)["model"]})
    Trainer(config.load_cfg(TINY, opts), str(tmp_path / "it1"), restore_model_path=str(init),
            device="cpu").train()
    assert "warm start from" in (tmp_path / "it1" / "log_train.txt").read_text()
    free = _metrics(tmp_path / "it1")
    got.append(free[0])
    post.append(CheckpointManager(str(tmp_path / "it1" / "ckpt")).restore(1)[0])
    # iterations 2 and 3: resumed from the JAX trainer's state before them
    for k in (1, 2):
        run = tmp_path / f"it{k + 1}"
        CheckpointManager(str(run / "ckpt")).save(k, _port_checkpoint(states[k], names, group))
        Trainer(config.load_cfg(TINY, opts), str(run), device="cpu").train(k + 1)
        assert f"restored checkpoint at step {k}" in (run / "log_train.txt").read_text()
        got.append(_metrics(run)[0])
        post.append(CheckpointManager(str(run / "ckpt")).restore(k + 1)[0])
    assert [m["iter"] for m in got] == [1, 2, 3]
    for g, w in zip(got, want):
        assert abs(g["total"] - w["total"]) <= TOTAL_RTOL * abs(w["total"]), (g, w)
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-7)
    assert len({round(w["total"], 3) for w in want}) == 3
    # the free-running port against the free-running JAX trainer
    record_property("free_running_total_rel_diff",
                    [abs(f["total"] - w["total"]) / abs(w["total"]) for f, w in zip(free, want)])

    # the state after each iteration, leaf by leaf
    b1, lr = group["b1"], group["lr"]
    for k in range(3):
        mine = _leaves(post[k], names)
        ref_ckpt = _port_checkpoint(after[k], names, group)
        ref = _leaves(ref_ckpt, names)
        before = _leaves(_port_checkpoint(states[k], names, group), names)
        assert post[k]["step"] == ref_ckpt["step"] == k + 1
        assert post[k]["optimizer"]["param_groups"][0]["count"] == \
            ref_ckpt["optimizer"]["param_groups"][0]["count"] == k + 1
        assert set(mine) == set(ref)
        for key in ref:
            if key.endswith((".mean", ".var")):
                err = (mine[key] - ref[key]).abs().max()
                assert err <= STAT_RTOL * ref[key].abs().max(), (k + 1, key, float(err))
        # the JAX trainer's (clipped) gradient of this iteration, from its moments
        grads = {n: (ref[f"mu:{n}"] - b1 * before[f"mu:{n}"]) / (1 - b1) for n in names}
        top = max(float(g.abs().max()) for g in grads.values())
        for name, g in grads.items():
            g_max = float(g.abs().max())
            if 0 < g_max <= ROUNDING_LEVEL * top:
                # at rounding level: a Dense bias that a BatchNorm follows
                # (its exact gradient is 0), whose update is lr * a sign
                # that each framework draws its own way
                assert name.endswith(".conv.bias") and \
                    f"{name[:-len('conv.bias')]}bn.scale" in ref, (k + 1, name, g_max / top)
                continue
            for moment in ("mu", "nu"):
                a, w = mine[f"{moment}:{name}"], ref[f"{moment}:{name}"]
                assert (a - w).norm() <= MOMENT_RTOL[k] * w.norm(), (k + 1, moment, name)
            resolved = g.abs() > RESOLVED * g_max
            err = (mine[name] - ref[name])[resolved].abs().max() if resolved.any() else 0.0
            assert err <= PARAM_TOL * lr, (k + 1, name, float(err) / lr)
