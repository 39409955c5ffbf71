"""Data-parallel and FSDP training of the PyTorch port over torch.distributed
(gloo on the CPU, two processes), against the single-process step on the
same global batch:

- the batch-size rule and the ranks' row ranges, and the loaders' row ranges;
- train-mode BatchNorm over the global batch, and the loss normalisers over
  it, on a batch whose halves hold different positive counts;
- one step of the shrunk flagship and of the tiny PointRCNN's stage 2 (its
  minibatch uniforms drawn for the global batch and sliced) under `dp` and
  `fsdp` (`entry.dryrun_multichip`): losses, gradient leaves and BatchNorm
  statistics at `parallel.steps`' tolerances, with the ranks' discrete
  decisions (ReLU signs, max-pool winners, ball members, FPS picks) taken
  by the single-process step where a rounding-level difference flipped one;
- `bin.train` under the SSD3D_DIST_* contract in two processes logs the
  single-process run's losses, and an fsdp run's checkpoint resumes in a
  single process.

Every subprocess call has a timeout. Run as a script, this file is one rank
of the BatchNorm and normaliser checks (`_rank_main`).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
CFG = "configs/kitti/3dssd/3dssd_tiny.yaml"
TIMEOUT = 300  # seconds, each subprocess
# each rank's intra-op threads: the ranks share the host with each other and
# with the test run's other workers
RANK_THREADS = "2"
# `bin.train`'s losses under dp or fsdp against a single process from the
# same state on the same batch: the ranks sum their shares in another order,
# f32 rounding. Runs are compared from shared states only (the first
# iteration; a checkpoint resumed), never free-running: a ReLU flipped by
# rounding moves the first gradient, and Adam's sign-like first update
# carries that into every parameter (the losses of iteration 3 part by 17%).
LOSS_RTOL = 1e-5

def _env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for key in ("SSD3D_DIST_COORDINATOR", "SSD3D_DIST_NUM_PROCESSES", "SSD3D_DIST_PROCESS_ID",
                "SSD3D_DIST_AUTO", "LOCAL_RANK"):
        env.pop(key, None)
    env.update(OMP_NUM_THREADS=RANK_THREADS, **extra)
    return env


def _ranks(argvs: list[list[str]], env_of) -> list[str]:
    """Start one process per argv (rank r's environment `env_of(r)`), wait
    for all with a timeout -> their outputs; raises on a failure."""
    procs = [subprocess.Popen([sys.executable, *argv], cwd=REPO, env=env_of(r),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r, argv in enumerate(argvs)]
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    return logs


# ---------------------------------------------- rows and the batch-size rule

def test_batch_size_rule_and_row_ranges():
    from ssd3d_torch.parallel.data_parallel import global_batch_size, row_range

    # ssd3d/train/trainer.py:201-203: cut to a multiple of the ranks, at
    # least one row a rank
    assert [global_batch_size(8, n) for n in (1, 2, 3, 4, 8, 16)] == [8, 8, 6, 8, 8, 16]
    assert global_batch_size(2, 4) == 4
    assert [row_range(8, r, 4) for r in range(4)] == [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert row_range(6, 2, 3) == (4, 6)
    with pytest.raises(ValueError, match="do not divide"):
        row_range(8, 0, 3)


def test_loaders_build_only_their_rows():
    """A loader with `row_range` yields exactly its rows of each batch of the
    deterministic global stream, and loads no other sample."""
    from ssd3d_torch.data import loader as kitti_loader
    from ssd3d_torch.data.nuscenes import NuScenesLoader

    class Fake:
        row_range = None

        def __init__(self):
            self.loaded = []

        def load_sample(self, i, epoch_seed=0):
            self.loaded.append(i)
            return {"name": str(i), "points": np.full((3, 4), i, np.float32)}

    block = [(0, i) for i in (7, 3, 9, 1)]
    fake = Fake()
    full = kitti_loader._collate_block(fake, block)
    fake.row_range, fake.loaded = (2, 4), []
    rows = kitti_loader._collate_block(fake, block)
    np.testing.assert_array_equal(rows["points"], full["points"][2:4])
    assert fake.loaded == [9, 1] and list(rows["names"]) == ["9", "1"]

    nusc = object.__new__(NuScenesLoader)
    nusc.names, nusc.seed, nusc.training, nusc.row_range = [str(i) for i in range(8)], 0, True, None
    nusc.BATCH_KEYS = ("points",)
    nusc.load_sample = lambda i, e: {"name": str(i), "points": np.full((2,), i, np.float32)}
    whole = [b["points"] for b in nusc.batches(4, epochs=1)]
    nusc.row_range = (1, 3)
    part = [b["points"] for b in nusc.batches(4, epochs=1)]
    assert len(whole) == len(part) == 2
    for w, p in zip(whole, part):
        np.testing.assert_array_equal(p, w[1:3])


# ------------------------------ BatchNorm and the normalisers over 2 ranks

def _bn_and_losses(world: int, rank: int) -> dict:
    """On this rank's rows: a train-mode BatchNorm's output, running
    statistics and input gradient; the classification and offset losses of
    a batch whose scans hold 3, 11, 0 and 6 positives, and their gradient
    through the scaled backward and a mean over the ranks (DDP's)."""
    from ssd3d_torch.nn.layers import BatchNorm
    from ssd3d_torch.parallel import data_parallel as dp
    from ssd3d_torch.train import losses

    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(4, 30, 8, 12) * 2 + 1).astype(np.float32))
    w = torch.from_numpy(rng.randn(4, 30, 8, 12).astype(np.float32))
    bs, npts = 4, 50
    pmask = np.zeros((bs, npts, 1), np.float32)
    for b, k in enumerate((3, 11, 0, 6)):
        pmask[b, rng.choice(npts, k, replace=False)] = 1.0
    nmask = (1.0 - pmask) * (rng.rand(bs, npts, 1) < 0.5)
    logits = torch.from_numpy(rng.randn(bs, npts, 1).astype(np.float32))
    offset = torch.from_numpy(rng.randn(bs, npts, 1, 6).astype(np.float32))
    gt_offset = torch.from_numpy(rng.randn(bs, npts, 1, 6).astype(np.float32))
    lo, hi = dp.row_range(bs, rank, world)
    bn = BatchNorm(12).train()
    xt = x[lo:hi].clone().requires_grad_(True)
    y = bn(xt, 0.7)
    (y * w[lo:hi]).sum().mul(dp.backward_scale()).backward()
    lg = logits[lo:hi].clone().requires_grad_(True)
    off = offset[lo:hi].clone().requires_grad_(True)
    cfg = losses.LossConfig("Is-Not", "Sigmoid", 1, 12)
    targets = {"pmask": torch.from_numpy(pmask[lo:hi]), "nmask": torch.from_numpy(nmask[lo:hi]),
               "gt_cls": torch.from_numpy(pmask[lo:hi, :, 0].astype(np.int32)),
               "gt_offset": gt_offset[lo:hi]}
    cls = losses.classification_loss(cfg, {"cls": lg}, targets)
    reg = losses.offset_loss_res(cfg, {"offset": off}, targets)
    (cls + reg).mul(dp.backward_scale()).backward()
    out = {"y": y.detach(), "dx": xt.grad, "mean": bn.mean.clone(), "var": bn.var.clone(),
           "dlogits": lg.grad, "doffset": off.grad,
           "losses": dp.sum_over_ranks({"cls": cls.detach(), "offset": reg.detach()})}
    if world > 1:
        # each rank's backward was scaled by the rank count, which DDP's
        # average over the ranks takes out of a parameter's gradient: the
        # gradients here are divided by it, as the average would
        for key, scale in (("dlogits", world), ("doffset", world), ("dx", world), ("y", 1)):
            parts = [torch.zeros_like(out[key]) for _ in range(world)]
            torch.distributed.all_gather(parts, out[key])
            out[key] = torch.cat(parts) / scale
    return out


def _rank_main(rank: int, world: int, port: int, out: str) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    try:
        res = _bn_and_losses(world, rank)
        if rank == 0:
            torch.save(res, out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def bn_and_losses(tmp_path_factory):
    from ssd3d_torch.entry import free_port

    out = str(tmp_path_factory.mktemp("bn") / "ranks.pt")
    port = free_port()
    _ranks([[__file__, str(r), "2", str(port), out] for r in range(2)], lambda r: _env())
    return torch.load(out), _bn_and_losses(1, 0)


def test_batchnorm_takes_the_global_batch_statistics(bn_and_losses):
    got, want = bn_and_losses
    for key in ("mean", "var"):  # the running statistics moved by the global batch's
        torch.testing.assert_close(got[key], want[key], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got["y"], want["y"], rtol=1e-5, atol=1e-5)
    # the input gradient through the all-reduced moments (each rank's
    # backward scaled by 2, then halved): the single-process gradient of
    # the global batch
    torch.testing.assert_close(got["dx"], want["dx"], rtol=1e-4, atol=1e-6)


def test_loss_normalisers_count_the_global_batch(bn_and_losses):
    """Rank 0's scans hold 3 + 11 positives, rank 1's 0 + 6: each rank
    divides by all 20 (and by the global classification count), so the
    summed losses and the averaged gradients are the single process's."""
    got, want = bn_and_losses
    for key in ("cls", "offset"):
        assert abs(float(got["losses"][key]) - float(want["losses"][key])) <= 1e-6 * abs(
            float(want["losses"][key])), key
    torch.testing.assert_close(got["dlogits"], want["dlogits"], rtol=1e-6, atol=1e-9)
    torch.testing.assert_close(got["doffset"], want["doffset"], rtol=1e-6, atol=1e-9)


# ------------------------------------------------- dp and fsdp train steps

@pytest.fixture(scope="module")
def dryrun():
    from ssd3d_torch.entry import dryrun_multichip

    with mock.patch.dict(os.environ, OMP_NUM_THREADS=RANK_THREADS):
        return dryrun_multichip(2, device="cpu")


@pytest.mark.parametrize("case", ["3dssd_shrunk", "pointrcnn2_tiny"])
@pytest.mark.parametrize("mode", ["dp", "fsdp"])
def test_parallel_step_matches_the_single_process_step(dryrun, case, mode):
    from ssd3d_torch.parallel import steps

    worst = dryrun[(case, mode)]
    assert worst["loss"] <= steps.LOSS_RTOL and worst["grad"] <= steps.GRAD_TOL
    assert worst["stats"] <= steps.STATS_TOL
    taken = worst["decisions taken otherwise"]
    # a handful of near-tie ReLU signs at most; no ball, pick or winner
    assert taken["relu"] <= 200 and taken["ball_query"] == taken["fps"] == taken["ffps"] == 0


def _replay_case(case: str):
    """(recorded `Decisions`, the call replayed on the other leg) of one
    replay case: a centre at the origin of a cloud whose point 1 lies just
    inside r = 0.3 and point 2 well inside; 64 more points far away."""
    from ssd3d_torch.parallel.steps import Decisions

    rng = np.random.RandomState(0)
    xyz = np.concatenate([[[0.0, 0.0, 0.0], [0.29999, 0.0, 0.0], [0.0, 0.2, 0.0]],
                          5.0 + rng.rand(64, 3)]).astype(np.float32)
    xyz = torch.from_numpy(xyz)[None]
    centre = torch.zeros(1, 1, 3)
    rec = Decisions()
    kind = "fps" if case.startswith("fps") else "ball_query"
    call = ((lambda d, pts: d.fps(pts, 8)) if kind == "fps" else
            (lambda d, pts, c=centre: d.ball_query([0.3], [4], pts, c)))
    call(rec, xyz)
    if case.endswith("tampered"):  # the recorded answer changed: a wrong one
        answers = rec.log[kind][0][1]
        answers[0][0, ..., 0] = answers[0][0, ..., 1] + 1 if kind == "fps" else 3
        if kind == "ball_query":
            answers[1].fill_(2)
    if case == "ball near a tie":  # the centre 2e-5 further: point 1 just outside
        centre = torch.tensor([[[-2e-5, 0.0, 0.0]]])
    if case == "ball away from a tie":  # the centre 0.05 away: point 2 leaves
        centre = torch.tensor([[[0.0, -0.15, 0.0]]])
    if case == "fps away from a tie tampered":  # other inputs and a wrong pick
        xyz = xyz + 1e-3
    return Decisions(rec.log), (lambda d: call(d, xyz) if kind == "fps" else
                                d.ball_query([0.3], [4], xyz, centre))


@pytest.mark.parametrize("case,outcome", [
    ("ball equal inputs", "taken"), ("fps equal inputs", "taken"),
    ("ball near a tie", "near-tie"),
    ("ball equal inputs tampered", "refused"), ("ball away from a tie", "refused"),
    ("fps equal inputs tampered", "refused"), ("fps away from a tie tampered", "refused")])
def test_decision_replay_takes_only_near_ties(case, outcome):
    """The replaying leg takes a recorded ball or pick sequence only where
    its inputs were the same and the answer is too, or where the answers
    part at a near-tie on its own inputs; any other difference raises."""
    replay, call = _replay_case(case)
    if outcome == "refused":
        with pytest.raises(AssertionError):
            call(replay)
        return
    call(replay)
    kind = "fps" if case.startswith("fps") else "ball_query"
    assert replay.consumed() and replay.differ[kind] == (outcome == "near-tie")


def test_sharded_global_norm_and_clip_match_the_whole_gradient():
    """Under FSDP the clip's norm is the whole gradient's: the shard sums
    all-reduced (here over one rank, the arithmetic path)."""
    from ssd3d_torch.train.train_step import clip_by_global_norm, global_norm

    rng = np.random.RandomState(5)
    grads = [torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in ((7, 5), (3,), (4, 4))]
    want = float(np.sqrt(sum(float((g.double() ** 2).sum()) for g in grads)))
    assert abs(float(global_norm(grads)) - want) <= 1e-6 * want
    clipped = [g.clone() for g in grads]
    clip_by_global_norm(clipped, max_norm=1.0)
    for c, g in zip(clipped, grads):
        torch.testing.assert_close(c, g / want, rtol=1e-5, atol=1e-7)


# ------------------------------------------- bin.train under SSD3D_DIST_*

@pytest.fixture(scope="module")
def kitti_tree(tmp_path_factory):
    from ssd3d_torch.utils import synth

    root = tmp_path_factory.mktemp("dist_cli")
    data, npz = root / "kitti", root / "npz"
    synth.write_tree(str(data), n_train=4, n_val=1, n_points=2600, seed=3, k_max=3)
    opts = ["--device", "cpu",
            "DATASET.KITTI.BASE_DIR_PATH", str(data),
            "DATASET.KITTI.TRAIN_LIST", str(data / "train.txt"),
            "DATASET.KITTI.VAL_LIST", str(data / "val.txt"),
            "DATASET.KITTI.SAVE_NUMPY_PATH", str(npz),
            "TRAIN.CONFIG.BATCH_SIZE", "2",
            "TRAIN.CONFIG.CHECKPOINT_INTERVAL", "2",
            "TRAIN.CONFIG.SUMMARY_INTERVAL", "1",
            "TRAIN.AUGMENTATIONS.MIXUP.NUMBER", "(3, )",
            "DATA_LOADER.NUM_PROCS", "0",
            # f32: at bf16 a rounding-level difference of the ranks' sums
            # moves a product by a bf16 step (2^-8)
            "TPU.COMPUTE_DTYPE", "float32"]
    _ranks([["-m", "ssd3d_torch.bin.preprocess", "--cfg", CFG, "--img_list", "train", *opts]],
           lambda r: _env())
    return root, opts


def _train(run: Path, opts: list, iters: int, ranks: int = 1, mode: str = "dp") -> list[str]:
    from ssd3d_torch.entry import free_port

    argv = ["-m", "ssd3d_torch.bin.train", "--cfg", CFG, "--log_dir", str(run),
            "--max_iterations", str(iters), *opts, "TPU.PARALLEL_MODE", mode]
    if ranks == 1:
        return _ranks([argv], lambda r: _env())
    port = free_port()
    return _ranks([argv] * ranks, lambda r: _env(
        SSD3D_DIST_COORDINATOR=f"localhost:{port}", SSD3D_DIST_NUM_PROCESSES=str(ranks),
        SSD3D_DIST_PROCESS_ID=str(r)))


def _metrics(run: Path) -> list[dict]:
    return [json.loads(line) for line in open(run / "metrics.jsonl")]


LOSS_KEYS = ("cls", "offset", "angle", "corner", "vote", "total")


def _same_losses(got: dict, want: dict, what: str) -> None:
    assert got["iter"] == want["iter"], what
    for key in LOSS_KEYS:
        assert abs(got[key] - want[key]) <= LOSS_RTOL * abs(want[key]), (
            what, got["iter"], key, got[key], want[key])


def _resume_alone(src: Path, run: Path, opts: list) -> dict:
    """A single-process `bin.train` to iteration 3 from `src`'s step-2
    checkpoint (copied into a fresh run dir) -> its iteration-3 metrics."""
    os.makedirs(run / "ckpt")
    shutil.copytree(src / "ckpt" / "2", run / "ckpt" / "2")
    _train(run, opts, 3)
    assert "restored checkpoint at step 2" in (run / "log_train.txt").read_text()
    (got,) = _metrics(run)
    return got


def test_bin_train_under_the_dist_contract_logs_the_single_process_losses(kitti_tree):
    """Two ranks of `bin.train` (dp, SSD3D_DIST_*): rank 0 alone writes,
    the first iteration logs the single process's losses, and a single
    process resumed from the dp run's step-2 checkpoint logs its iteration
    3."""
    root, opts = kitti_tree
    _train(root / "single", opts, 1)
    logs = _train(root / "dp", opts, 3, ranks=2)
    assert "distributed: process 1/2 on the CPU, backend gloo" in "".join(logs)
    lead = (root / "dp" / "log_train.txt").read_text()
    assert "dp over 2 ranks: rank 0 trains on rows [0, 1] of 2" in lead
    single, dp = _metrics(root / "single"), _metrics(root / "dp")
    assert [m["iter"] for m in dp] == [1, 2, 3] and [m["iter"] for m in single] == [1]
    _same_losses(dp[0], single[0], "dp against one process, iteration 1")
    assert sorted(os.listdir(root / "dp" / "ckpt")) == ["2", "3"]
    _same_losses(_resume_alone(root / "dp", root / "dp_resumed", opts), dp[2],
                 "one process from dp's step 2 against dp")


def test_fsdp_checkpoint_resumes_in_a_single_process(kitti_tree):
    """An fsdp run's checkpoint is the full state dict in the single-process
    format (whole tensors, Adam's moments by parameter index); a single
    process resumed from its step 2 logs the fsdp run's iteration 3 (the
    moments restored, else the update differs)."""
    root, opts = kitti_tree
    run = root / "fsdp"
    _train(run, opts, 3, ranks=2, mode="fsdp")
    fsdp = _metrics(run)
    assert [m["iter"] for m in fsdp] == [1, 2, 3]
    ckpt = torch.load(run / "ckpt" / "2" / "state.pt", weights_only=True)
    single = torch.load(root / "single" / "ckpt" / "1" / "state.pt", weights_only=True)
    assert ckpt["step"] == 2
    assert {k: (type(v), tuple(v.shape)) for k, v in ckpt["model"].items()} == \
        {k: (type(v), tuple(v.shape)) for k, v in single["model"].items()}
    assert set(ckpt["optimizer"]["state"]) == set(single["optimizer"]["state"])
    for i, s in single["optimizer"]["state"].items():
        for key in ("mu", "nu"):
            assert type(ckpt["optimizer"]["state"][i][key]) is torch.Tensor
            assert ckpt["optimizer"]["state"][i][key].shape == s[key].shape
    _same_losses(fsdp[0], _metrics(root / "single")[0], "fsdp against one process, iteration 1")
    _same_losses(_resume_alone(run, root / "fsdp_resumed", opts), fsdp[2],
                 "one process from fsdp's step 2 against fsdp")

if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
