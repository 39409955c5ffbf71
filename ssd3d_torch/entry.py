"""Entry points of the port, with seeded weights: the flagship 3DSSD
detector (KITTI Car, `configs/kitti/3dssd/3dssd.yaml`), PointRCNN (KITTI
Car, `configs/kitti/pointrcnn/pointrcnn_test.yaml`) and its two training
stages (`pointrcnn_stage1.yaml`, `pointrcnn_stage2.yaml`), on 16,384-point
scans.

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

    step, batch = two_stage_train_entry(stage=1)   # PointRCNN's RPN, batch 4
    metrics = step(batch)     # loss_stage0/* (stage 2: loss_stage1/* too)
    state = step.args[0]
"""

from __future__ import annotations

import functools
import math
from pathlib import Path

import numpy as np
import torch

from ssd3d_torch.config import load_cfg
from ssd3d_torch.models.api import build_pipeline
from ssd3d_torch.models.single_stage import build_detector
from ssd3d_torch.nn.layers import BatchNorm, Dense
from ssd3d_torch.train.train_step import TrainGraph
from ssd3d_torch.utils.synth import make_scene

CONFIGS = Path(__file__).resolve().parents[1] / "configs" / "kitti"
FLAGSHIP_CFG = CONFIGS / "3dssd" / "3dssd.yaml"
POINTRCNN_CFG = CONFIGS / "pointrcnn" / "pointrcnn_test.yaml"


def init_weights(model: torch.nn.Module, seed: int = 0) -> None:
    """The JAX package's init rules from a seeded CPU generator (so every
    device gets the same numbers): xavier-uniform Dense kernels, zero biases,
    BatchNorm scale 1, bias 0, mean 0, var 1."""
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


def flagship(shrink: int = 1, compute_dtype: str | None = None,
             device: torch.device | str = "cuda", seed: int = 0):
    """-> (cfg, model, spec, n). `shrink` divides the FPS ranges, sample
    counts and scan size as `__graft_entry__._flagship` does (widths stay);
    `compute_dtype` ("float32" | "bfloat16") overrides TPU.COMPUTE_DTYPE."""
    cfg = load_cfg(str(FLAGSHIP_CFG))
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


def two_stage_train_entry(device: torch.device | str = "cuda", stage: int = 1, batch: int = 4,
                          seed: int = 0):
    """(step, batch): a PointRCNN training stage at full width with seeded
    weights (`configs/kitti/pointrcnn/pointrcnn_stage{stage}.yaml`; stage 1
    trains the RPN, stage 2 the RCNN with the RPN frozen), its TwoStageGraph
    and TrainState, and a fixed batch of synthetic scenes on `device` (the
    configs' global batch is BATCH_SIZE 2 x GPU_NUM 2 = 4). `step(batch)`
    runs one optimizer step, drawing stage 2's minibatch from (seed, step),
    and returns its metrics; the TrainState is `step.args[0]`."""
    if stage not in (1, 2):
        raise ValueError(f"two_stage_train_entry: stage {stage} is not 1 or 2")
    cfg = load_cfg(str(CONFIGS / "pointrcnn" / f"pointrcnn_stage{stage}.yaml"))
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


def two_stage_entry(device: torch.device | str = "cuda", seed: int = 0, batch: int = 4):
    """(fn, (points,)): fn runs PointRCNN inference (RPN, proposals, RCNN,
    NMS) on `batch` synthetic KITTI-like scans made from `seed` and returns
    the detection dict with `proposals` and `proposals_valid`."""
    cfg, pipe = _pointrcnn_pipeline(1, device, seed)
    n = cfg.MODEL.POINTS_NUM_FOR_TRAINING
    points = torch.from_numpy(synthetic_scenes(batch, n, seed)["points"]).to(device)
    return pipe.infer, (points,)
