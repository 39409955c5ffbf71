"""Entry points of the port, with seeded weights: the flagship 3DSSD
detector (KITTI Car, `configs/kitti/3dssd/3dssd.yaml`) and its train step,
also with the training options no shipped config turns on
(`train_options_entry`), PointRCNN (KITTI Car,
`configs/kitti/pointrcnn/pointrcnn_test.yaml`) and its two training stages
(`pointrcnn_stage1.yaml`, `pointrcnn_stage2.yaml`), and STD
(`configs/kitti/std/std.yaml`), on 16,384-point scans; and 3DSSD on
nuScenes (`nuscenes`, `configs/nuscenes/3dssd/3dssd.yaml`).

Counterpart of `__graft_entry__._flagship` / `entry` and the single-device
train step of `__graft_entry__._dryrun_body`. Every entry point runs on the
card unless the caller asks for the CPU (`device="cpu"`); without a card the
default raises. Usage:

    from ssd3d_torch.entry import entry, train_entry, two_stage_entry
    fn, (points,) = entry()
    detections = fn(points)   # dict of boxes / scores / classes / valid / index

    step, batch = train_entry()   # batch 8 of 16,384-point scans
    metrics = step(batch)     # one optimizer step: losses, total, lr, norms
    state = step.args[0]      # the TrainState: step counter, model, optimizer

    fn, (points,) = two_stage_entry()   # PointRCNN, batch 4
    detections = fn(points)   # as above, plus proposals / proposals_valid
    fn, (points,) = two_stage_entry(config="std")   # STD, batch 4

    step, batch = two_stage_train_entry(stage=1)   # PointRCNN's RPN, batch 4
    metrics = step(batch)     # loss_stage0/* (stage 2: loss_stage1/* too)
    state = step.args[0]

    dryrun_multichip()        # dp and fsdp steps, one NCCL process a card
    dryrun_multichip(2, device="cpu")   # the same in 2 gloo processes
"""

from __future__ import annotations

import functools
import math
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from ssd3d_torch.config import load_cfg
from ssd3d_torch.data.loader import KittiLoader
from ssd3d_torch.models.api import build_pipeline
from ssd3d_torch.models.single_stage import build_detector
from ssd3d_torch.nn.layers import BatchNorm, Dense, GroupNorm
from ssd3d_torch.train.train_step import TrainGraph
from ssd3d_torch.utils.synth import GROUND_Y, make_scene, sample_cars

CONFIGS = Path(__file__).resolve().parents[1] / "configs" / "kitti"
FLAGSHIP_CFG = CONFIGS / "3dssd" / "3dssd.yaml"
POINTRCNN_CFG = CONFIGS / "pointrcnn" / "pointrcnn_test.yaml"
STD_CFG = CONFIGS / "std" / "std.yaml"
NUSCENES_CFG = CONFIGS.parent / "nuscenes" / "3dssd" / "3dssd.yaml"
# the flagship's rows grouped by attention where asked (SA1 and SA2)
ATTENTION_LAYERS = (0, 1)
# the KITTI training options no shipped config turns on, as config overrides
# of the flagship: an IoU head beside its detection head, Dist-Anchor
# regression (the IoU branch needs anchor boxes), AdaBound and the
# augmentation on the device
TRAIN_OPTIONS = ["MODEL.NETWORK.FIRST_STAGE.HEAD",
                 "[[[6], [6], 'conv1d', [128], True, 'Det', ''], "
                 "[[6], [6], 'conv1d', [128], True, 'IoU', 'iou_head']]",
                 "MODEL.FIRST_STAGE.REGRESSION_METHOD.TYPE", "Dist-Anchor",
                 "SOLVER.TYPE", "AdaBound",
                 "TPU.DEVICE_AUGMENT", "True"]


def init_weights(model: torch.nn.Module, seed: int = 0) -> None:
    """The JAX package's init rules from a seeded CPU generator (so every
    device gets the same numbers): xavier-uniform Dense kernels, zero biases,
    BatchNorm scale 1, bias 0, mean 0, var 1; GroupNorm scale 1, bias 0."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Dense):
                c_in, c_out = mod.kernel.shape
                limit = math.sqrt(6.0 / (c_in + c_out))
                k = torch.rand(c_in, c_out, generator=gen) * (2 * limit) - limit
                mod.kernel.copy_(k)
                mod.bias.zero_()
            elif isinstance(mod, BatchNorm):
                mod.scale.fill_(1.0)
                mod.bias.zero_()
                mod.mean.zero_()
                mod.var.fill_(1.0)
            elif isinstance(mod, GroupNorm):
                mod.scale.fill_(1.0)
                mod.bias.zero_()


def flagship(shrink: int = 1, compute_dtype: str | None = None,
             device: torch.device | str = "cuda", seed: int = 0, opts=(), attention=()):
    """-> (cfg, model, spec, n). `shrink` divides the FPS ranges, sample
    counts and scan size as `__graft_entry__._flagship` does (widths stay);
    `compute_dtype` ("float32" | "bfloat16") overrides TPU.COMPUTE_DTYPE;
    `opts` are config overrides (key, value, ...); `attention` lists the
    architecture rows whose ball queries take attention order (ATTENTION_LAYERS:
    SA1 and SA2, as the JAX package's attention train test sets them)."""
    cfg = load_cfg(str(FLAGSHIP_CFG), list(opts))
    for row in attention:
        cfg.MODEL.NETWORK.FIRST_STAGE.ARCHITECTURE[row][10] = True
    if shrink > 1:
        for layer in cfg.MODEL.NETWORK.FIRST_STAGE.ARCHITECTURE:
            layer[6] = [r if r == -1 else r // shrink for r in layer[6]]
            layer[8] = [p if p == -1 else p // shrink for p in layer[8]]
        cfg.MODEL.POINTS_NUM_FOR_TRAINING //= shrink
    if compute_dtype is not None:
        cfg.TPU.COMPUTE_DTYPE = compute_dtype
    n = cfg.MODEL.POINTS_NUM_FOR_TRAINING
    model, spec = build_detector(cfg, device=device)
    init_weights(model, seed)
    return cfg, model, spec, n


def nuscenes(compute_dtype: str | None = None, device: torch.device | str = "cuda",
             seed: int = 0):
    """-> (cfg, model, spec): 3DSSD on nuScenes (`configs/nuscenes/3dssd/
    3dssd.yaml`: 10 classes, anchor-free, the velocity and attribute heads,
    200 outputs a class) at full widths and depth with seeded weights;
    `compute_dtype` overrides TPU.COMPUTE_DTYPE (bf16 as shipped). Its
    scans come from `data.nuscenes.NuScenesLoader` (10 aggregated sweeps,
    voxel-budgeted to 16,384 points of x, y, z and time lag)."""
    cfg = load_cfg(str(NUSCENES_CFG))
    if compute_dtype is not None:
        cfg.TPU.COMPUTE_DTYPE = compute_dtype
    model, spec = build_detector(cfg, device=device)
    init_weights(model, seed)
    return cfg, model, spec


def entry(device: torch.device | str = "cuda", seed: int = 0):
    """(fn, (points,)): fn runs the flagship forward, decode and NMS on a
    [1, 16384, 4] scan made from `seed`."""
    _, model, spec, n = flagship(device=device, seed=seed)
    pts = np.random.RandomState(seed).randn(1, n, 4).astype(np.float32) * 10
    points = torch.from_numpy(pts).to(device)

    @torch.inference_mode()
    def fn(points: torch.Tensor) -> dict:
        return spec.decode_and_nms(model(points))

    return fn, (points,)


def synthetic_scenes(batch: int, n: int, seed: int = 0, max_boxes: int = 6) -> dict:
    """`batch` synthetic KITTI-like scans (ground plane, car shells, clutter
    from `utils.synth.make_scene`) of n points each, with their car
    boxes zero-padded to `max_boxes` rows (label 1 for a car, 0 for padding).
    -> numpy arrays points f32 [b, n, 4], gt_boxes f32 [b, max_boxes, 7],
    gt_labels int32 [b, max_boxes]."""
    rng = np.random.default_rng(seed)
    points = np.zeros((batch, n, 4), np.float32)
    gt_boxes = np.zeros((batch, max_boxes, 7), np.float32)
    gt_labels = np.zeros((batch, max_boxes), np.int32)
    for b in range(batch):
        pts, boxes = make_scene(rng, n_points=n + 2048, k_max=max_boxes)
        points[b] = pts[rng.choice(len(pts), n, replace=len(pts) < n)]
        gt_boxes[b, :len(boxes)] = boxes
        gt_labels[b, :len(boxes)] = 1
    return {"points": points, "gt_boxes": gt_boxes, "gt_labels": gt_labels}


def train_entry(device: torch.device | str = "cuda", seed: int = 0, batch: int = 8,
                shrink: int = 1):
    """(step, batch): the flagship in train mode with seeded weights, its
    TrainGraph and TrainState, and a fixed batch of synthetic scenes on
    `device` (the config's global batch is BATCH_SIZE 4 x GPU_NUM 2 = 8).
    `step(batch)` runs one optimizer step and returns its metrics; the
    TrainState is `step.args[0]`."""
    cfg, model, spec, n = flagship(shrink=shrink, device=device, seed=seed)
    graph = TrainGraph.build(cfg, model, spec)
    state = graph.init_state()
    data = synthetic_scenes(batch, n, seed)
    return (functools.partial(graph.train_step, state),
            {k: torch.from_numpy(v).to(device) for k, v in data.items()})


def synthetic_candidates(batch: int, k: int, p: int, seed: int = 0) -> dict:
    """GT-crop candidates for the device augmentation's paste, as the
    loader emits them (`KittiLoader._mixup_candidates`): k car boxes a scan
    on the flat road of the synthetic scenes, each with p points inside it
    (`utils.synth.sample_cars` and uniform interior points), all valid, and
    the road plane -> numpy arrays cand_points [b, k, p, 4], cand_boxes
    [b, k, 7], cand_labels [b, k], cand_valid [b, k], plane [b, 4]."""
    rng = np.random.default_rng(seed + 1)
    cand_points = np.zeros((batch, k, p, 4), np.float32)
    cand_boxes = np.zeros((batch, k, 7), np.float32)
    for b in range(batch):
        boxes = sample_cars(rng, k)
        while len(boxes) < k:
            boxes = np.concatenate([boxes, sample_cars(rng, k)])[:k]
        cand_boxes[b] = boxes[:k]
        for i, (x, y, z, l, h, w, ry) in enumerate(boxes[:k]):
            local = rng.uniform(-0.5, 0.5, (p, 3)) * [l, h, w] + [0.0, -h / 2, 0.0]
            c, s_ = np.cos(ry), np.sin(ry)
            cand_points[b, i, :, 0] = x + c * local[:, 0] + s_ * local[:, 2]
            cand_points[b, i, :, 1] = y + local[:, 1]
            cand_points[b, i, :, 2] = z - s_ * local[:, 0] + c * local[:, 2]
            cand_points[b, i, :, 3] = rng.uniform(0, 1, p)
    return {"cand_points": cand_points, "cand_boxes": cand_boxes,
            "cand_labels": np.ones((batch, k), np.int32),
            "cand_valid": np.ones((batch, k), bool),
            "plane": np.tile(np.float32([0.0, -1.0, 0.0, GROUND_Y]), (batch, 1))}


def train_options_entry(device: torch.device | str = "cuda", seed: int = 0, batch: int = 8,
                        shrink: int = 1, compute_dtype: str | None = None,
                        cand_points: int = KittiLoader.CAND_POINTS):
    """(step, batch) as `train_entry` gives them, for the flagship with the
    training options of `TRAIN_OPTIONS` (an IoU head, Dist-Anchor
    regression, AdaBound, the augmentation on the device), its batch with
    the paste's candidates (15 a scan, the config's MIXUP NUMBER, of
    `cand_points` points, the loader's cap of 512 by default; the 15 crops'
    points must not outnumber a scan's) and the road plane; `step(batch)`
    draws the augmentation from (seed, step)."""
    cfg, model, spec, n = flagship(shrink=shrink, compute_dtype=compute_dtype, device=device,
                                   seed=seed, opts=TRAIN_OPTIONS)
    graph = TrainGraph.build(cfg, model, spec)
    state = graph.init_state()
    data = synthetic_scenes(batch, n, seed)
    data.update(synthetic_candidates(batch, int(sum(cfg.TRAIN.AUGMENTATIONS.MIXUP.NUMBER)),
                                     cand_points, seed))
    return (functools.partial(graph.train_step, state, seed=seed),
            {k: torch.from_numpy(v).to(device) for k, v in data.items()})


def two_stage_train_entry(device: torch.device | str = "cuda", stage: int = 1, batch: int = 4,
                          seed: int = 0, config: str = "pointrcnn"):
    """(step, batch): a PointRCNN training stage at full width with seeded
    weights (`configs/kitti/pointrcnn/pointrcnn_stage{stage}.yaml`; stage 1
    trains the RPN, stage 2 the RCNN with the RPN frozen; with config "std"
    stage 2 is STD's, `configs/kitti/std/std_stage2.yaml`), its TwoStageGraph
    and TrainState, and a fixed batch of synthetic scenes on `device` (the
    configs' global batch is BATCH_SIZE 2 x GPU_NUM 2 = 4). `step(batch)`
    runs one optimizer step, drawing stage 2's minibatch from (seed, step),
    and returns its metrics; the TrainState is `step.args[0]`."""
    if stage not in (1, 2) or config not in ("pointrcnn", "std"):
        raise ValueError(f"two_stage_train_entry: stage {stage}, config {config!r}")
    cfg = load_cfg(str(CONFIGS / "std" / "std_stage2.yaml") if (config, stage) == ("std", 2)
                   else str(CONFIGS / "pointrcnn" / f"pointrcnn_stage{stage}.yaml"))
    pipe = build_pipeline(cfg, nms_pre_topk=cfg.TPU.NMS_PRE_TOPK or 2048, device=device)
    init_weights(pipe.model, seed)
    state = pipe.graph.init_state()
    data = synthetic_scenes(batch, cfg.MODEL.POINTS_NUM_FOR_TRAINING, seed)
    return (functools.partial(pipe.graph.train_step, state, seed=seed),
            {k: torch.from_numpy(v).to(device) for k, v in data.items()})


def _pointrcnn_pipeline(shrink: int, device, seed: int):
    cfg = load_cfg(str(POINTRCNN_CFG))
    if shrink > 1:
        for layer in cfg.MODEL.NETWORK.FIRST_STAGE.ARCHITECTURE:
            layer[8] = [p // shrink for p in layer[8]]
        cfg.MODEL.POINTS_NUM_FOR_TRAINING //= shrink
    pipe = build_pipeline(cfg, device=device)
    init_weights(pipe.model, seed)
    return cfg, pipe


def pointrcnn(shrink: int = 1, device: torch.device | str = "cuda", seed: int = 0):
    """-> (cfg, model, rpn_spec, rcnn_spec, n): PointRCNN at full widths and
    depth with seeded weights, f32 (COMPUTE_DTYPE as shipped), 100 proposals,
    nms_pre_topk 2048. `shrink` divides the RPN's sample counts and the scan
    size n (the RoI pool keeps its 512 points)."""
    cfg, pipe = _pointrcnn_pipeline(shrink, device, seed)
    return cfg, pipe.model, pipe.rpn_spec, pipe.rcnn_spec, cfg.MODEL.POINTS_NUM_FOR_TRAINING


def std(device: torch.device | str = "cuda", seed: int = 0):
    """-> (cfg, pipeline): STD (`configs/kitti/std/std.yaml`: PointRCNN's
    RPN, the PointsPool voxel pooler, 100 proposals) at full widths and
    depth with seeded weights, f32 as shipped."""
    cfg = load_cfg(str(STD_CFG))
    pipe = build_pipeline(cfg, device=device)
    init_weights(pipe.model, seed)
    return cfg, pipe


def two_stage_entry(device: torch.device | str = "cuda", seed: int = 0, batch: int = 4,
                    config: str = "pointrcnn"):
    """(fn, (points,)): fn runs two-stage inference (RPN, proposals, RCNN,
    NMS) on `batch` synthetic KITTI-like scans made from `seed` and returns
    the detection dict with `proposals` and `proposals_valid`; `config` is
    "pointrcnn" (`pointrcnn_test.yaml`) or "std" (`std.yaml`)."""
    if config not in ("pointrcnn", "std"):
        raise ValueError(f"two_stage_entry: config {config!r} is not pointrcnn or std")
    cfg, pipe = (_pointrcnn_pipeline(1, device, seed) if config == "pointrcnn"
                 else std(device, seed))
    n = cfg.MODEL.POINTS_NUM_FOR_TRAINING
    points = torch.from_numpy(synthetic_scenes(batch, n, seed)["points"]).to(device)
    return pipe.infer, (points,)


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(n: int, device: str, cases, modes, timed: int = 0, record: bool = False,
              timeout: float = 600) -> dict:
    """Run `parallel.steps` as n processes (one rank each; on the card, rank
    r on card r) -> rank 0's records, with `record` the ranks' decisions.
    Each process has `timeout` seconds; any failure raises with its
    output."""
    with tempfile.TemporaryDirectory(prefix="ssd3d_ranks_") as tmp:
        out = os.path.join(tmp, "records.pt")
        port = free_port()
        env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1]))
        args = [f"--{k}={v}" for k, vs in (("case", cases), ("mode", modes)) for v in vs]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "ssd3d_torch.parallel.steps", f"--rank={r}", f"--world={n}",
             f"--port={port}", f"--device={device}", f"--timed={timed}", f"--out={out}",
             *(["--record"] if record else []), *args],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(n)]
        try:
            logs = [p.communicate(timeout=timeout)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode for p in procs):
            raise RuntimeError("ranks failed (exit codes "
                               f"{[p.returncode for p in procs]}):\n" + "\n".join(logs))
        from ssd3d_torch.parallel.steps import load_records

        return load_records(out)


def dryrun_multichip(n: int | None = None, device: str = "cuda") -> dict:
    """The port's counterpart of `__graft_entry__.dryrun_multichip`: one
    train step of the shrunk flagship and of the tiny PointRCNN's stage 2
    in n processes (NCCL on n cards, every card by default; gloo on the CPU
    with device="cpu", 2 by default), in `dp` and in `fsdp`, each held to
    the single-process step on the same global batch, the ranks' decisions
    taken there (`parallel.steps.Decisions`, each difference a near-tie;
    `parallel.steps.compare`: losses, gradient leaves, BatchNorm
    statistics) -> {(case, mode): worst relative errors}."""
    from ssd3d_torch.parallel import steps

    if n is None:
        n = torch.cuda.device_count() if device == "cuda" else 2
    cases, modes = ("3dssd_shrunk", "pointrcnn2_tiny"), ("dp", "fsdp")
    got = run_ranks(n, device, cases, modes, record=n > 1)
    worst = {}
    for case in cases:
        for mode in modes:
            rec = got[(case, mode)]
            taken = steps.Decisions(rec.decisions) if rec.decisions else None
            want = steps.single_step(case, device, decisions=taken)
            worst[(case, mode)] = steps.compare(rec, want, f"{case} {mode} over {n} ranks")
            worst[(case, mode)]["decisions taken otherwise"] = dict(taken.differ) if taken else {}
            print(f"dryrun_multichip: {case} {mode} over {n} {device} ranks matches the "
                  f"single-process step: worst relative errors {worst[(case, mode)]}")
    return worst
