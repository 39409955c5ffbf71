"""Training runtime: the port's train step (single-stage, or PointRCNN's
two-stage step), `torch.save` checkpoints and metrics logging (counterpart
of `ssd3d/train/trainer.py`, itself the replacement of the reference
trainer, lib/core/trainer.py), on one device or one process a card.

A checkpoint is one step directory `<ckpt>/<step>/state.pt` holding the
step, the model's `state_dict` (parameters and BatchNorm buffers) and the
optimizer's `state_dict` (Adam's moments and step count, or SGD's momentum),
every tensor on the CPU, so a checkpoint written on the card loads with
`device="cpu"`. Each save writes a temporary directory and renames it: a
reader polling the directory (the evaluate daemon) never sees half a
checkpoint. The trainer runs on the card unless asked for the CPU; its
loader's worker processes start by forkserver on every device (a process
that has initialised CUDA must not fork).

Multi-GPU: under the SSD3D_DIST_* contract (`parallel.distributed`) each
process trains on its card as one rank of a process group, on its rows of
the global batch (`data_parallel.row_range`, BATCH_SIZE x GPU_NUM, cut to a
multiple of the rank count as the JAX trainer cuts it), with TPU.PARALLEL_MODE
`dp` (DDP) or `fsdp` (FSDP2). Rank 0 alone writes the logs, metrics.jsonl
and checkpoints; a checkpoint holds the full state dict (every shard
gathered) in the single-process format, so dp, fsdp and single-process runs
resume each other's checkpoints.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ssd3d_torch.data import build_loader
from ssd3d_torch.entry import init_weights
from ssd3d_torch.models.api import build_pipeline
from ssd3d_torch.ops import _build
from ssd3d_torch.parallel import data_parallel as dp
from ssd3d_torch.parallel.distributed import initialize_from_env, rank, rank_device, world
from ssd3d_torch.train.train_step import TrainState
from ssd3d_torch.utils.tf_checkpoint import convert_tf_checkpoint

STATE_FILE = "state.pt"
# how the loader's worker processes start, on every device: one clean server
# process, forked from for each worker (a process that has initialised CUDA
# must not fork itself)
WORKER_START = "forkserver"


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):  # a sharded tensor whole (every rank gathers)
        return dp.full(tree.detach()).to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def checkpoint_of(state: TrainState) -> dict:
    """A TrainState -> the checkpoint dict (step, model, optimizer), every
    tensor copied to the CPU whole (under FSDP every rank takes part)."""
    return {"step": int(state.step),
            "model": _to_cpu(state.model.state_dict()),
            "optimizer": _to_cpu(state.optimizer.state_dict())}


def load_checkpoint(state: TrainState, ckpt: dict) -> None:
    """Restore a TrainState in place from a checkpoint dict: parameters,
    BatchNorm buffers, optimizer state and step; whole tensors are sharded
    as the state's are (FSDP)."""
    current = state.model.state_dict()
    state.model.load_state_dict({k: dp.shard_like(v, current[k]) if k in current else v
                                 for k, v in ckpt["model"].items()})
    params = [p for group in state.optimizer.param_groups for p in group["params"]]
    opt = ckpt["optimizer"]
    state.optimizer.load_state_dict(dict(opt, state={
        i: {k: dp.shard_like(v, params[i]) if torch.is_tensor(v) else v for k, v in s.items()}
        for i, s in opt["state"].items()}))
    state.step = int(ckpt["step"])


def _read(path: str, map_location) -> dict:
    return torch.load(os.path.join(path, STATE_FILE), map_location=map_location,
                      weights_only=True)


class CheckpointManager:
    """Numeric step directories under `ckpt_dir` with rotation past
    `max_to_keep` (the reference keeps 10, config.py:121-123)."""

    def __init__(self, ckpt_dir: str, max_to_keep: int = 10):
        self.dir = os.path.abspath(ckpt_dir)
        self.max_to_keep = max_to_keep
        os.makedirs(self.dir, exist_ok=True)

    def all_steps(self, refresh: bool = False) -> list[int]:
        """The saved steps, ascending. The directory is read on every call,
        so a daemon polling a live run sees later saves; `refresh` is
        accepted for the JAX package's signature."""
        return sorted(int(d) for d in os.listdir(self.dir)
                      if d.isdigit() and os.path.isfile(os.path.join(self.dir, d, STATE_FILE)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, ckpt: dict) -> None:
        """Write `ckpt` (a checkpoint dict, see `checkpoint_of`) as step
        `step`, atomically, then drop the oldest steps past max_to_keep."""
        tmp = tempfile.mkdtemp(prefix=f".tmp-{step}-", dir=self.dir)
        torch.save(ckpt, os.path.join(tmp, STATE_FILE))
        final = os.path.join(self.dir, str(step))
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.dir, str(old)), ignore_errors=True)

    def restore(self, step: int | None = None, map_location="cpu"):
        """-> (checkpoint dict, step), or (None, None) where there is none."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        return _read(os.path.join(self.dir, str(step)), map_location), step


def restore_from_path(path: str, step: int | None = None, map_location="cpu"):
    """Read a checkpoint from any path shape users pass as
    `--restore_model_path` (the reference evaluator/tester/trainer CLIs,
    evaluator.py:21 / tester.py:21 / trainer.py:27): a run dir (containing
    ckpt/), a manager dir (numeric step subdirs), or a single copied step
    dir (e.g. the evaluator's best_ckpt). Returns (checkpoint dict, step)."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"restore_model_path {path!r} not found")
    if os.path.isdir(os.path.join(path, "ckpt")):
        path = os.path.join(path, "ckpt")
    if any(d.isdigit() for d in os.listdir(path)):
        return CheckpointManager(path).restore(step, map_location)
    if not os.path.isfile(os.path.join(path, STATE_FILE)):
        raise FileNotFoundError(
            f"{path!r} is neither a run dir, a checkpoint dir, nor a saved "
            "step directory"
        )
    ckpt = _read(path, map_location)
    base = os.path.basename(path)
    return ckpt, int(base) if base.isdigit() else int(ckpt["step"])


def merge_by_name(dst: dict, src: dict):
    """Copy the tensors of state dict `src` into a copy of state dict `dst`
    wherever the key AND the shape match, in dst's dtype and device.

    The reference's transfer restore intersects checkpoint variable names
    with graph variables and skips everything else (trainer.py:161-174,
    get_variables_in_checkpoint_file trainer_utils.py:48-54). Returns
    (merged, copied_keys, skipped_keys); `skipped` lists dst keys the
    source did not provide (or provided with a different shape)."""
    merged, copied, skipped = {}, [], []
    for key, value in dst.items():
        sv = src.get(key)
        if isinstance(sv, torch.Tensor) and tuple(sv.shape) == tuple(value.shape):
            merged[key] = sv.to(dtype=value.dtype, device=value.device)
            copied.append(key)
        else:
            merged[key] = value
            skipped.append(key)
    return merged, copied, skipped


class Trainer:
    """End-to-end KITTI or nuScenes training (the reference trainer.py CLI
    body): single-stage models and PointRCNN's stages, the loader on host
    workers, a checkpoint every CHECKPOINT_INTERVAL and at the end,
    metrics every SUMMARY_INTERVAL. Resume is batch-exact: the loader's
    stream starts at the restored step, and PointRCNN's minibatch draws
    come from a generator seeded by the seed and the step. Stage 2 of
    PointRCNN starts from a stage-1 run by `restore_model_path`. Under the
    SSD3D_DIST_* contract, or in a process group the caller started, it is
    one rank of a data-parallel run (module docstring)."""

    def __init__(self, cfg, log_dir: str, split: str = "train", seed: int = 0,
                 restore_model_path: str | None = None,
                 restore_tf_checkpoint: str | None = None,
                 device: torch.device | str = "cuda"):
        if cfg.TPU.PARALLEL_MODE not in ("dp", "fsdp"):
            raise ValueError(f"unknown TPU.PARALLEL_MODE {cfg.TPU.PARALLEL_MODE!r}")
        device = _build.resolve_device(device)
        # the process group (and this rank's card) before anything is built
        self.owns_group = initialize_from_env(print, device)
        self.device = rank_device(device)
        self.world, self.rank = world(), rank()
        # under a process group every rank runs the same program; rank 0
        # alone owns the run dir's files (JAX trainer.py:171-173)
        self.is_lead = self.rank == 0
        self.parallel = cfg.TPU.PARALLEL_MODE if dist.is_initialized() else None
        self.cfg = cfg
        self.seed = seed
        self.log_dir = os.path.abspath(log_dir)
        os.makedirs(self.log_dir, exist_ok=True)
        self.log_file = open(os.path.join(self.log_dir, "log_train.txt") if self.is_lead
                             else os.devnull, "a")
        self.metrics_file = open(os.path.join(self.log_dir, "metrics.jsonl") if self.is_lead
                                 else os.devnull, "a")
        if self.is_lead:
            # config snapshot into the run dir (trainer.py:59)
            with open(os.path.join(self.log_dir, "config_snapshot.json"), "w") as f:
                json.dump(cfg.to_dict(), f, indent=1, default=str)

        pipeline = build_pipeline(cfg, nms_pre_topk=cfg.TPU.NMS_PRE_TOPK or 2048,
                                  device=self.device)
        init_weights(pipeline.model, seed)
        self.graph = pipeline.graph
        self.loader = build_loader(cfg, split, training=True, seed=seed,
                                   device_aug=cfg.TPU.DEVICE_AUGMENT)
        self.batch_size = dp.global_batch_size(
            cfg.TRAIN.CONFIG.BATCH_SIZE * cfg.TRAIN.CONFIG.GPU_NUM, self.world)
        if self.batch_size != cfg.TRAIN.CONFIG.BATCH_SIZE * cfg.TRAIN.CONFIG.GPU_NUM:
            self.log(f"batch size adjusted to {self.batch_size} for {self.world} ranks")
        if self.parallel:
            # this rank loads only its rows of each global batch
            self.loader.row_range = dp.row_range(self.batch_size, self.rank, self.world)
            self.log(f"{self.parallel} over {self.world} ranks: rank {self.rank} trains on rows "
                     f"{list(self.loader.row_range)} of {self.batch_size} on {self.device}")
        self.ckpt = CheckpointManager(os.path.join(self.log_dir, "ckpt"),
                                      cfg.TRAIN.CONFIG.MAX_CHECKPOINTS_TO_KEEP)
        self.restore_model_path = restore_model_path
        self.restore_tf_checkpoint = restore_tf_checkpoint
        batch_keys = ["points", "gt_boxes", "gt_labels"]
        if cfg.DATASET.TYPE.upper() == "NUSCENES":
            # the velocity / attribute heads' labels (data/nuscenes.py)
            batch_keys += ["gt_velocity", "gt_attribute"]
        if cfg.TPU.DEVICE_AUGMENT and cfg.TRAIN.AUGMENTATIONS.OPEN:
            # the device augmentation's inputs (train/device_aug.py)
            batch_keys += ["plane"]
            if cfg.TRAIN.AUGMENTATIONS.MIXUP.OPEN:
                batch_keys += ["cand_points", "cand_boxes", "cand_labels", "cand_valid"]
        self.batch_keys = tuple(batch_keys)

    def log(self, msg: str) -> None:
        if not self.is_lead:
            return
        line = f"[{time.strftime('%H:%M:%S')}] {msg}"
        print(line, flush=True)
        self.log_file.write(line + "\n")
        self.log_file.flush()

    def _device_batch(self, batch: dict) -> dict:
        return {k: torch.from_numpy(batch[k]).to(self.device) for k in self.batch_keys}

    def init_or_restore(self) -> TrainState:
        """This run's latest checkpoint if it has one, else fresh weights,
        warm-started from `restore_model_path` when given; wrapped for the
        run's parallel mode (the warm start before, the checkpoint after:
        it is sharded as the state is). A reference TF checkpoint
        (`restore_tf_checkpoint`) is converted into the fresh weights after
        any warm start, as the JAX trainer does."""
        ckpt, step = self.ckpt.restore(map_location=self.device)
        if ckpt is None and self.restore_model_path:
            self._warm_start(self.graph.model, self.restore_model_path)
        if ckpt is None and self.restore_tf_checkpoint:
            model = self.graph.model
            converted, missing = convert_tf_checkpoint(self.restore_tf_checkpoint, self.cfg,
                                                       model.state_dict(), log=self.log)
            model.load_state_dict(converted)
            self.log(f"TF checkpoint {self.restore_tf_checkpoint} converted "
                     f"({len(missing)} unmatched paths)")
        state = self.graph.init_state(self.parallel)
        if ckpt is not None:
            load_checkpoint(state, ckpt)
            self.log(f"restored checkpoint at step {step}")
        return state

    def _warm_start(self, model: torch.nn.Module, path: str) -> None:
        """Transfer restore from another run (reference --restore_model_path,
        trainer.py:161-174): copy the tensors whose names and shapes
        intersect; the step and the optimizer state start fresh."""
        raw, step = restore_from_path(path, map_location=self.device)
        if raw is None:
            raise FileNotFoundError(f"no checkpoint under {path!r}")
        merged, copied, skipped = merge_by_name(model.state_dict(), raw["model"])
        model.load_state_dict(merged)
        self.log(
            f"warm start from {path} (step {step}): {len(copied)} tensors restored, "
            f"{len(skipped)} left at init" + (f" (e.g. {skipped[0]})" if skipped else "")
        )

    def _draw(self, batch: dict, it: int) -> None:
        """BEV and 3D PNGs and an HTML viewer of the batch's first scan, in
        place of the reference's TF BEV image summary and mayavi viewer."""
        from ssd3d_torch.utils.viz import draw_bev, draw_scene_3d, dump_scene_html

        bev_dir = os.path.join(self.log_dir, "bev")
        s3d_dir = os.path.join(self.log_dir, "scene3d")
        os.makedirs(bev_dir, exist_ok=True)
        os.makedirs(s3d_dir, exist_ok=True)
        gt = batch["gt_boxes"][0]
        gt = gt[np.any(gt != 0, axis=-1)]
        pts = np.asarray(batch["points"][0])
        draw_bev(pts, os.path.join(bev_dir, f"iter_{it:07d}.png"), gt_boxes=gt)
        draw_scene_3d(pts, os.path.join(s3d_dir, f"iter_{it:07d}.png"), gt_boxes=gt)
        dump_scene_html(pts, os.path.join(s3d_dir, f"iter_{it:07d}.html"), gt_boxes=gt)

    def train(self, max_iterations: int | None = None) -> TrainState:
        cfg = self.cfg.TRAIN.CONFIG
        max_iters = max_iterations or cfg.MAX_ITERATIONS
        state = self.init_or_restore()
        start_step = state.step
        num_procs = self.cfg.DATA_LOADER.NUM_PROCS
        if num_procs < 0:  # auto: processes only when the host runs the
            # augmentation chain (measured faster: benchmarks/bench_loader.py)
            num_procs = 4 if self.loader.augmentor is not None else 0
        if num_procs:
            self.log(f"loader: {num_procs} worker processes started by {WORKER_START}")
        batch_gen = self.loader.batches(
            self.batch_size,
            num_threads=self.cfg.DATA_LOADER.NUM_THREADS,
            num_procs=num_procs,
            mp_method=WORKER_START,
            # resume is batch-exact: fast-forward the pure index stream to
            # the restored step so the data sequence continues as if the
            # run had never been stopped
            start_iter=start_step,
        )
        it = start_step
        saved = start_step if start_step else None
        t_last = time.perf_counter()
        waited = 0.0
        try:
            while it < max_iters:
                t0 = time.perf_counter()
                batch = next(batch_gen, None)
                if batch is None:
                    break
                waited += time.perf_counter() - t0
                metrics = self.graph.train_step(state, self._device_batch(batch), self.seed)
                it += 1
                if it % cfg.SUMMARY_INTERVAL == 0:
                    metrics = {k: float(v) for k, v in metrics.items()}  # waits for the step
                    now = time.perf_counter()
                    dt = (now - t_last) / cfg.SUMMARY_INTERVAL
                    wait = waited / cfg.SUMMARY_INTERVAL
                    t_last, waited = now, 0.0
                    self.log(
                        f"iter {it}/{max_iters} "
                        + " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items()))
                        + f" ({dt:.3f}s/it, {wait:.3f}s waiting for the loader)"
                    )
                    self.metrics_file.write(json.dumps(
                        {"iter": it, "sec_per_it": dt, "loader_wait_s": wait, **metrics}) + "\n")
                    self.metrics_file.flush()
                if it % cfg.CHECKPOINT_INTERVAL == 0:
                    self._save(it, state)
                    saved = it
                    if cfg.SUMMARY_BEV_IMAGES and self.is_lead:
                        self._draw(batch, it)
        finally:
            # tear the worker pool down now (the generator's finally),
            # before the process group goes
            batch_gen.close()
        if saved != it:
            self._save(it, state)
        self.log(f"training done at iter {it}")
        self.log_file.close()
        self.metrics_file.close()
        if self.owns_group:
            dist.barrier()
            dist.destroy_process_group()
        return state

    def _save(self, it: int, state: TrainState) -> None:
        """Every rank gathers the checkpoint (FSDP's shards); rank 0 writes."""
        ckpt = checkpoint_of(state)
        if self.is_lead:
            self.ckpt.save(it, ckpt)
            self.log(f"saved checkpoint at iter {it}")
