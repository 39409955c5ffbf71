"""Single-stage train step (counterpart of `ssd3d/train/train_step.py`):
the device augmentation where TPU.DEVICE_AUGMENT asks for it
(`device_aug.py`), forward in train mode, target assignment, losses (with an
IoU head, its branch), backward and the optimizer update.

The update is optax's chain as the JAX package builds it: clip by global
norm 5.0, written as optax writes it ((g / norm) * 5 only when the norm
reaches 5; `clip_grad_norm_` adds 1e-6 and differs), then Adam (b1 0.9,
b2 0.999, eps 1e-8) or SGD with momentum, with the learning rate of the step
before its increment, or AdaBound (`adabound.py`, its own schedule).
`torch.optim.SGD` computes optax's SGD update. Adam is
written out (`Adam` below) because optax rounds its bias corrections to
float32, where 1 - 0.999^t loses five digits and moves the first updates by
~1e-5 relative from `torch.optim.Adam`, which keeps them in float64.
With TRAIN_PARAM_PREFIX only the matching top-level modules reach the
optimizer (`trained_parameters`), so the clip's norm and Adam see only them,
as optax's `multi_transform` does. Parameters, BatchNorm buffers and the
optimizer state are updated in place.

Under data parallelism (`init_state(parallel="dp" | "fsdp")`, one process
a card) the step's forward runs through the wrapped loss module
(`parallel.data_parallel.wrap`), each rank's backward is scaled by the
rank count, the metrics are summed over the ranks, the clip takes the norm
of the whole gradient (of every shard under FSDP) and the step's draws are
the global batch's, each rank keeping its rows: the step equals the
single-process step on the global batch.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ssd3d_torch.parallel import data_parallel as dp
from ssd3d_torch.parallel.distributed import world
from ssd3d_torch.train import losses as L
from ssd3d_torch.train.adabound import AdaBound
from ssd3d_torch.train.assigner import AssignerConfig, assign_targets
from ssd3d_torch.train.device_aug import AugDraws, augment_batch
from ssd3d_torch.train.device_aug import draw as draw_augmentation
from ssd3d_torch.train.schedules import bn_momentum, learning_rate
from ssd3d_torch.utils.profiling import span

MAX_GRAD_NORM = 5.0


class Adam(torch.optim.Optimizer):
    """optax.adam's arithmetic: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 +
    b2 nu, update = -lr (mu / bc1) / (sqrt(nu / bc2) + eps) with the bias
    corrections bc = 1 - b^t rounded to float32 as optax computes them.
    Multi-tensor (`torch._foreach_*`) ops, a handful of launches a step,
    on each tensor's local shard under FSDP (the update is elementwise; a
    sharded tensor's ops would each go through its Python dispatch)."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    self.state[p].update(mu=torch.zeros_like(p), nu=torch.zeros_like(p))
            group["count"] = count = group.get("count", 0) + 1
            b1, b2 = group["b1"], group["b2"]
            grads = [dp.local(p.grad) for p in params]
            mu = [dp.local(self.state[p]["mu"]) for p in params]
            nu = [dp.local(self.state[p]["nu"]) for p in params]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
            bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
            bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            update = torch._foreach_div(mu, bc1)
            torch._foreach_div_(update, denom)
            torch._foreach_add_([dp.local(p) for p in params], update, alpha=-group["lr"])


def trained_parameters(model: torch.nn.Module, train_param_prefix=()) -> list:
    """The parameters the optimizer updates: with TRAIN_PARAM_PREFIX, those
    whose top-level module name starts with one of the prefixes (the
    reference's stage-wise freezing, trainer_utils.py:56); else all. The
    others keep their values, as optax's `set_to_zero` keeps them."""
    prefixes = tuple(train_param_prefix)
    return [p for name, p in model.named_parameters()
            if not prefixes or name.split(".", 1)[0].startswith(prefixes)]


def make_optimizer(solver_cfg, params) -> torch.optim.Optimizer:
    """Adam, SGD + momentum or AdaBound over `params`; the learning rate is
    set each step from `learning_rate` (`apply_update`; AdaBound reads the
    schedule itself, `train/adabound.py`)."""
    lr = learning_rate(solver_cfg, 0)
    if solver_cfg.TYPE == "Adam":
        return Adam(params, lr=lr)
    if solver_cfg.TYPE == "SGD":
        return torch.optim.SGD(params, lr=lr, momentum=solver_cfg.MOMENTUM)
    if solver_cfg.TYPE == "AdaBound":
        return AdaBound(params, schedule=lambda step: learning_rate(solver_cfg, step))
    raise ValueError(f"unknown solver {solver_cfg.TYPE}")


def global_norm(tensors) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of squares of every entry. The
    entries of FSDP2's sharded tensors are summed shard by shard and
    all-reduced, so the norm is the whole tensors' on every rank."""
    tensors = list(tensors)
    plain = [t for t in tensors if dp.local(t) is t]
    sharded = [dp.local(t) for t in tensors if dp.local(t) is not t]
    total = sum((t.float() * t.float()).sum() for t in plain)
    if sharded:
        part = sum((t.float() * t.float()).sum() for t in sharded)
        dist.all_reduce(part)
        total = total + part
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float = MAX_GRAD_NORM) -> None:
    """optax.clip_by_global_norm in place: (g / norm) * max_norm when norm
    >= max_norm, g otherwise. Decided on the device (no host sync); a
    sharded gradient is scaled shard by shard."""
    norm = global_norm(grads)
    keep = norm < max_norm
    for g in map(dp.local, grads):
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))


@dataclasses.dataclass
class TrainState:
    """Step counter, the model (parameters and BatchNorm buffers) and the
    optimizer (its state); the counterpart of the JAX TrainState. Under
    data parallelism `parallel` is the graph's loss module wrapped in DDP
    or FSDP2, through which every step's forward runs."""

    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    parallel: torch.nn.Module | None = None


def new_state(graph, train_param_prefix, parallel: str | None = None) -> TrainState:
    """A graph's TrainState at step 0: the model in train mode, wrapped for
    `parallel` ("dp" or "fsdp" over the default process group; FSDP2
    shards the parameters in place, so the optimizer comes after), and the
    optimizer over the trained parameters."""
    graph.model.train()
    wrapped = dp.wrap(graph, parallel) if parallel else None
    opt = make_optimizer(graph.solver_cfg, trained_parameters(graph.model, train_param_prefix))
    return TrainState(step=0, model=graph.model, optimizer=opt, parallel=wrapped)


def apply_update(state: TrainState, lr: float) -> None:
    """After the backward: clip the gradients of the optimizer's parameters
    by their global norm and step the optimizer at `lr`. A parameter the loss
    does not reach takes a zero gradient, as JAX's gradient tree holds one
    (Adam's moments stay 0 and its value stays)."""
    params = [p for group in state.optimizer.param_groups for p in group["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    clip_by_global_norm([p.grad for p in params])
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.step += 1


def optimizer_step(state: TrainState, solver_cfg, compute_losses,
                   histograms: bool = False) -> dict:
    """One optimizer step of either graph: `compute_losses(bn_m)` -> (total,
    loss dict) at this step's BatchNorm momentum, its backward, then
    `apply_update` at this step's learning rate. Updates `state` in place and
    returns the metrics (the loss dict, `total`, `lr`, and with `histograms`
    `grad_norm` and `param_norm`) as tensors on the model's device, but
    `lr`, a float. Under data parallelism the backward is scaled by the rank
    count (`dp.backward_scale`) and the losses are the global batch's,
    summed over the ranks. Spans: `ssd3d.train.step` around it all; under it
    the forward, targets and loss (opened by `compute_losses`), the
    backward, the metrics and the update."""
    with span("ssd3d.train.step"):
        bn_m = bn_momentum(solver_cfg, state.step)
        lr = learning_rate(solver_cfg, state.step)
        state.model.zero_grad(set_to_none=True)
        total, loss_dict = compute_losses(bn_m)
        with span("ssd3d.train.backward"):
            (total * dp.backward_scale() if world() > 1 else total).backward()
        with span("ssd3d.train.metrics"):
            metrics = dp.sum_over_ranks({k: v.detach() for k, v in loss_dict.items()}
                                        | {"total": total.detach()})
            metrics["lr"] = lr
            if histograms:
                metrics["grad_norm"] = global_norm(
                    [p.grad for p in state.model.parameters() if p.grad is not None])
        with span("ssd3d.train.update"):
            apply_update(state, lr)
        if histograms:
            with span("ssd3d.train.metrics"), torch.no_grad():
                metrics["param_norm"] = global_norm(list(state.model.parameters()))
        return metrics


@dataclasses.dataclass(frozen=True)
class TrainGraph:
    """Everything static the train step needs."""

    model: Any  # SingleStageDetector
    spec: Any  # DetectorSpec
    loss_cfg: L.LossConfig
    assigner_cfg: AssignerConfig
    solver_cfg: Any
    train_param_prefix: tuple = ()
    aug_cfg: Any = None  # TRAIN.AUGMENTATIONS when TPU.DEVICE_AUGMENT is on
    # SUMMARY_HISTOGRAMS: global grad / param norms in the metrics
    histograms: bool = False

    @classmethod
    def build(cls, cfg, model, spec) -> "TrainGraph":
        net = cfg.MODEL.NETWORK.FIRST_STAGE
        device_aug = cfg.TPU.DEVICE_AUGMENT and cfg.TRAIN.AUGMENTATIONS.OPEN
        return cls(
            model=model,
            spec=spec,
            loss_cfg=L.LossConfig.from_cfg(
                cfg, "FIRST_STAGE", vote=any(l[11] == "Vote_Layer" for l in net.ARCHITECTURE),
                iou=any(h[5] == "IoU" for h in net.HEAD)),
            assigner_cfg=AssignerConfig.from_cfg(cfg.MODEL.FIRST_STAGE),
            solver_cfg=cfg.SOLVER,
            train_param_prefix=tuple(cfg.TRAIN.CONFIG.TRAIN_PARAM_PREFIX),
            aug_cfg=cfg.TRAIN.AUGMENTATIONS if device_aug else None,
            histograms=bool(cfg.TRAIN.CONFIG.SUMMARY_HISTOGRAMS),
        )

    def init_state(self, parallel: str | None = None) -> TrainState:
        """Puts the model in train mode, wraps it for data parallelism
        `parallel` ("dp" | "fsdp", under a process group) and builds its
        optimizer (`new_state`)."""
        return new_state(self, self.train_param_prefix, parallel)

    def compute_losses(self, batch: dict, bn_m: float, draws: AugDraws | None = None):
        """batch: points [bs, n, 3 + c], gt_boxes [bs, g, 7], gt_labels
        [bs, g] (nuScenes: also gt_velocity [bs, g, 2] and gt_attribute [bs,
        g]; with device augmentation also the loader's plane and candidates,
        augmented first with `draws`) -> (total, loss dict).
        Moves the BatchNorm running statistics by `bn_m` (the JAX version
        returns them as mutated batch_stats)."""
        with span("ssd3d.train.forward"):
            if self.aug_cfg is not None:
                batch = augment_batch(batch, self.aug_cfg, draws)
            outputs = self.model(batch["points"], bn_m)
        base_xyz = outputs["base_xyz"]
        with span("ssd3d.train.targets"):
            anchors = self.spec.anchors(base_xyz)
            targets = assign_targets(self.assigner_cfg, base_xyz, anchors,
                                     batch["gt_boxes"], batch["gt_labels"],
                                     gt_velocity=batch.get("gt_velocity"),
                                     gt_attribute=batch.get("gt_attribute"))
        with span("ssd3d.train.loss"):
            loss_dict = L.compute_stage_losses(self.loss_cfg, self.spec.coder, outputs, targets,
                                               anchors, base_xyz,
                                               gt_boxes_scene=batch["gt_boxes"])
            return sum(loss_dict.values()), loss_dict

    def train_step(self, state: TrainState, batch: dict, seed: int = 0,
                   draws: AugDraws | None = None) -> dict:
        """One optimizer step (`optimizer_step`). With device augmentation
        its draws are `draws` where given, else drawn from a generator on
        the batch's device seeded by (seed, step), so that a resumed run
        draws what the unbroken run drew; without, the step draws nothing.
        Under data parallelism the draws are the global batch's and this
        rank keeps its rows."""
        if self.aug_cfg is not None and draws is None:
            points = batch["points"]
            gen = torch.Generator(device=points.device).manual_seed((seed << 32) + state.step)
            full = draw_augmentation(gen, points.shape[0] * world(), points.shape[1],
                                     batch["gt_boxes"].shape[1], points.device)
            draws = AugDraws(**{f.name: dp.local_rows(getattr(full, f.name))
                                for f in dataclasses.fields(AugDraws)})
        losses = state.parallel or self.compute_losses
        return optimizer_step(state, self.solver_cfg,
                              lambda bn_m: losses(batch, bn_m, draws), self.histograms)
