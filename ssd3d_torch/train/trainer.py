"""Training runtime on one device: the port's train step, `torch.save`
checkpoints and metrics logging (counterpart of `ssd3d/train/trainer.py`,
itself the replacement of the reference trainer, lib/core/trainer.py).

A checkpoint is one step directory `<ckpt>/<step>/state.pt` holding the
step, the model's `state_dict` (parameters and BatchNorm buffers) and the
optimizer's `state_dict` (Adam's moments and step count, or SGD's momentum),
every tensor on the CPU, so a checkpoint written on the card loads with
`device="cpu"`. Each save writes a temporary directory and renames it: a
reader polling the directory (the evaluate daemon) never sees half a
checkpoint. The trainer runs on the card unless asked for the CPU; its
loader's worker processes start by forkserver on every device (a process
that has initialised CUDA must not fork). The JAX package's multi-host and fsdp
branches are not ported (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from ssd3d_torch.data import build_loader
from ssd3d_torch.entry import init_weights
from ssd3d_torch.models.single_stage import build_detector
from ssd3d_torch.ops import _build
from ssd3d_torch.train.train_step import TrainGraph, TrainState

STATE_FILE = "state.pt"
# how the loader's worker processes start, on every device: one clean server
# process, forked from for each worker (a process that has initialised CUDA
# must not fork itself)
WORKER_START = "forkserver"


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def checkpoint_of(state: TrainState) -> dict:
    """A TrainState -> the checkpoint dict (step, model, optimizer), every
    tensor copied to the CPU."""
    return {"step": int(state.step),
            "model": _to_cpu(state.model.state_dict()),
            "optimizer": _to_cpu(state.optimizer.state_dict())}


def load_checkpoint(state: TrainState, ckpt: dict) -> None:
    """Restore a TrainState in place from a checkpoint dict: parameters,
    BatchNorm buffers, optimizer state and step."""
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
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
    """End-to-end KITTI training on one device (the reference trainer.py
    CLI body): single-stage models, the loader on host workers, a
    checkpoint every CHECKPOINT_INTERVAL and at the end, metrics every
    SUMMARY_INTERVAL. Resume is batch-exact: the loader's stream starts at
    the restored step."""

    def __init__(self, cfg, log_dir: str, split: str = "train", seed: int = 0,
                 restore_model_path: str | None = None,
                 restore_tf_checkpoint: str | None = None,
                 device: torch.device | str = "cuda"):
        if restore_tf_checkpoint:
            raise NotImplementedError(
                "Trainer: --restore_tf_checkpoint is not ported yet (ROADMAP Queue 1 item 13)")
        if cfg.TPU.PARALLEL_MODE == "fsdp":
            raise NotImplementedError(
                "Trainer: PARALLEL_MODE fsdp is not ported yet (ROADMAP Queue 1 item 12)")
        if cfg.TPU.PARALLEL_MODE != "dp":
            raise ValueError(f"unknown TPU.PARALLEL_MODE {cfg.TPU.PARALLEL_MODE!r}")
        if cfg.MODEL.TYPE == "DoubleStage":
            raise NotImplementedError(
                "Trainer: two-stage training is not ported yet (ROADMAP Queue 1 item 10)")
        self.device = _build.resolve_device(device)
        self.cfg = cfg
        self.seed = seed
        self.log_dir = os.path.abspath(log_dir)
        os.makedirs(self.log_dir, exist_ok=True)
        self.log_file = open(os.path.join(self.log_dir, "log_train.txt"), "a")
        self.metrics_file = open(os.path.join(self.log_dir, "metrics.jsonl"), "a")
        # config snapshot into the run dir (trainer.py:59)
        with open(os.path.join(self.log_dir, "config_snapshot.json"), "w") as f:
            json.dump(cfg.to_dict(), f, indent=1, default=str)

        model, spec = build_detector(cfg, device=self.device)
        init_weights(model, seed)
        self.graph = TrainGraph.build(cfg, model, spec)
        self.loader = build_loader(cfg, split, training=True, seed=seed,
                                   device_aug=cfg.TPU.DEVICE_AUGMENT)
        self.batch_size = cfg.TRAIN.CONFIG.BATCH_SIZE * cfg.TRAIN.CONFIG.GPU_NUM
        self.ckpt = CheckpointManager(os.path.join(self.log_dir, "ckpt"),
                                      cfg.TRAIN.CONFIG.MAX_CHECKPOINTS_TO_KEEP)
        self.restore_model_path = restore_model_path
        self.batch_keys = ("points", "gt_boxes", "gt_labels")

    def log(self, msg: str) -> None:
        line = f"[{time.strftime('%H:%M:%S')}] {msg}"
        print(line, flush=True)
        self.log_file.write(line + "\n")
        self.log_file.flush()

    def _device_batch(self, batch: dict) -> dict:
        return {k: torch.from_numpy(batch[k]).to(self.device) for k in self.batch_keys}

    def init_or_restore(self) -> TrainState:
        """This run's latest checkpoint if it has one, else fresh weights,
        warm-started from `restore_model_path` when given."""
        state = self.graph.init_state()
        ckpt, step = self.ckpt.restore(map_location=self.device)
        if ckpt is not None:
            load_checkpoint(state, ckpt)
            self.log(f"restored checkpoint at step {step}")
        elif self.restore_model_path:
            self._warm_start(state, self.restore_model_path)
        return state

    def _warm_start(self, state: TrainState, path: str) -> None:
        """Transfer restore from another run (reference --restore_model_path,
        trainer.py:161-174): copy the tensors whose names and shapes
        intersect; the step and the optimizer state start fresh."""
        raw, step = restore_from_path(path, map_location=self.device)
        if raw is None:
            raise FileNotFoundError(f"no checkpoint under {path!r}")
        merged, copied, skipped = merge_by_name(state.model.state_dict(), raw["model"])
        state.model.load_state_dict(merged)
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
        t_last = time.perf_counter()
        waited = 0.0
        try:
            while it < max_iters:
                t0 = time.perf_counter()
                batch = next(batch_gen, None)
                if batch is None:
                    break
                waited += time.perf_counter() - t0
                metrics = self.graph.train_step(state, self._device_batch(batch))
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
                    self.ckpt.save(it, checkpoint_of(state))
                    self.log(f"saved checkpoint at iter {it}")
                    if cfg.SUMMARY_BEV_IMAGES:
                        self._draw(batch, it)
        finally:
            # tear the worker pool down now (the generator's finally)
            batch_gen.close()
        if self.ckpt.latest_step() != it:
            self.ckpt.save(it, checkpoint_of(state))
        self.log(f"training done at iter {it}")
        self.log_file.close()
        self.metrics_file.close()
        return state
