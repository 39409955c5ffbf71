"""Two-stage (PointRCNN) train step (counterpart of
`ssd3d/train/two_stage_step.py`).

The RPN's forward in train mode, stage-1 targets and losses, then (unless
ONLY_FIRST_STAGE) the stage-2 part on data cut from the RPN's outputs: the
proposal NMS, the pooler's context mask, IoU assignment on the proposals,
a random minibatch of MINIBATCH_NUM proposals a scan (`gather_by_mask`),
RoI pooling, the RCNN's forward in train mode and the stage-2 losses.
TRAIN_LOSS_PREFIX chooses the losses that are summed and TRAIN_PARAM_PREFIX
the parameters that are updated (`train_step.trained_parameters`).

Where every `rpn*` module is frozen, the RPN runs under `torch.no_grad()`, in
train mode all the same: its BatchNorm statistics move, as the reference's
`mutable=["batch_stats"]` moves them, and its parameters stay. This cuts the
RPN's backward graph, as the JAX package's stop-gradient at its feature
output does.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch

from ssd3d_torch.core.geometry import boxes_bottom_to_center
from ssd3d_torch.models.two_stage import expand_boxes
from ssd3d_torch.ops.grouping import query_boxes_3d_mask
from ssd3d_torch.ops.sampling import gather_by_mask
from ssd3d_torch.parallel import data_parallel as dp
from ssd3d_torch.parallel.distributed import world
from ssd3d_torch.train import losses as L
from ssd3d_torch.train.assigner import AssignerConfig, assign_targets
from ssd3d_torch.train.train_step import TrainState, new_state, optimizer_step
from ssd3d_torch.utils.profiling import span


def gather_tree_by_mask(tree: dict, mask: torch.Tensor, k: int) -> dict:
    """`gather_by_mask` over every [bs, n, ...] tensor of a dict."""

    def one(x):
        bs, n = x.shape[:2]
        return gather_by_mask(x.reshape(bs, n, -1), mask, k).reshape((bs, k) + x.shape[2:])

    return {key: one(v) for key, v in tree.items()}


@dataclasses.dataclass(frozen=True)
class TwoStageGraph:
    """Everything static the two-stage train step needs."""

    model: Any  # TwoStageDetector
    rpn_spec: Any  # StageSpec
    rcnn_spec: Any  # ProposalSpec
    loss_cfg_1: L.LossConfig
    loss_cfg_2: L.LossConfig
    assigner_1: AssignerConfig
    assigner_2: AssignerConfig
    solver_cfg: Any
    only_first_stage: bool
    minibatch: int
    pool_context: float
    pool_mask_thresh: float
    loss_prefixes: tuple
    train_param_prefix: tuple
    freeze_rpn: bool

    @classmethod
    def build(cls, cfg, model, rpn_spec, rcnn_spec) -> "TwoStageGraph":
        net1 = cfg.MODEL.NETWORK.FIRST_STAGE
        prefix = tuple(cfg.TRAIN.CONFIG.TRAIN_PARAM_PREFIX)
        return cls(
            model=model,
            rpn_spec=rpn_spec,
            rcnn_spec=rcnn_spec,
            loss_cfg_1=L.LossConfig.from_cfg(
                cfg, "FIRST_STAGE", vote=any(l[11] == "Vote_Layer" for l in net1.ARCHITECTURE)),
            loss_cfg_2=L.LossConfig.from_cfg(cfg, "SECOND_STAGE"),
            assigner_1=AssignerConfig.from_cfg(cfg.MODEL.FIRST_STAGE),
            assigner_2=AssignerConfig.from_cfg(cfg.MODEL.SECOND_STAGE),
            solver_cfg=cfg.SOLVER,
            only_first_stage=cfg.MODEL.ONLY_FIRST_STAGE,
            minibatch=cfg.MODEL.SECOND_STAGE.MINIBATCH_NUM,
            pool_context=net1.POINTS_POOLER[4],
            pool_mask_thresh=net1.POOLER_MASK_THRESHOLD,
            loss_prefixes=tuple(cfg.TRAIN.CONFIG.TRAIN_LOSS_PREFIX),
            train_param_prefix=prefix,
            freeze_rpn=bool(prefix) and not any(p.startswith("rpn") for p in prefix),
        )

    def init_state(self, parallel: str | None = None) -> TrainState:
        """Puts the model in train mode, wraps it for data parallelism
        `parallel` ("dp" | "fsdp") and builds the optimizer over the
        trained parameters (`train_step.new_state`)."""
        return new_state(self, self.train_param_prefix, parallel)

    def compute_losses(self, batch: dict, bn_m: float, uniforms: torch.Tensor | None = None):
        """batch: points [bs, n, 4], gt_boxes [bs, g, 7], gt_labels [bs, g];
        uniforms: stage 2's draws (`train_step`) -> (total, loss dict
        with `loss_stage0/*` and `loss_stage1/*` keys). Moves the BatchNorm
        running statistics by `bn_m`."""
        model = self.model
        gt_boxes, gt_labels = batch["gt_boxes"], batch["gt_labels"]
        with span("ssd3d.train.forward"), \
                torch.no_grad() if self.freeze_rpn else contextlib.nullcontext():
            rpn_out = model.rpn(batch["points"], bn_m)
        base_xyz = rpn_out["base_xyz"]
        with span("ssd3d.train.targets"):
            anchors1 = self.rpn_spec.anchors(base_xyz)
            targets1 = assign_targets(self.assigner_1, base_xyz, anchors1, gt_boxes, gt_labels)
        with span("ssd3d.train.loss"):
            losses1 = L.compute_stage_losses(self.loss_cfg_1, self.rpn_spec.coder, rpn_out,
                                             targets1, anchors1, base_xyz, gt_boxes_scene=gt_boxes)
        loss_dict = {f"loss_stage0/{k}": v for k, v in losses1.items()}

        if not self.only_first_stage:
            # the proposals, their targets and the minibatch are data: the
            # stage-1 gradients flow through the stage-1 losses only
            rpn_sg = {k: v.detach() if torch.is_tensor(v) else v for k, v in rpn_out.items()}
            with span("ssd3d.train.targets"), torch.no_grad():
                proposals, targets2 = self.stage2_targets(rpn_sg, gt_boxes, gt_labels, uniforms)
                base_mask = (torch.sigmoid(rpn_sg["cls"].amax(-1, keepdim=True))
                             >= self.pool_mask_thresh).float()
            feature = rpn_sg["feature"] if self.freeze_rpn else rpn_out["feature"]
            with span("ssd3d.train.forward"):
                rcnn_out = model.rcnn(rpn_sg["base_xyz"], feature, base_mask, proposals, bn_m)
            rcnn_out["proposals"] = proposals
            with span("ssd3d.train.loss"):
                losses2 = L.compute_stage_losses(
                    self.loss_cfg_2, self.rcnn_spec.coder, rcnn_out, targets2,
                    proposals[:, :, None, :], boxes_bottom_to_center(proposals)[..., 0:3])
            loss_dict.update({f"loss_stage1/{k}": v for k, v in losses2.items()})

        if self.loss_prefixes:
            trained = [v for k, v in loss_dict.items() if k.startswith(self.loss_prefixes)]
        else:
            trained = list(loss_dict.values())
        return sum(trained), loss_dict

    def stage2_targets(self, rpn_sg: dict, gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                       uniforms: torch.Tensor | None):
        """The RPN's (detached) outputs -> (the minibatch of proposals
        [bs, MINIBATCH_NUM, 7], their stage-2 targets): class-unaware NMS,
        a proposal counts where the box grown by the pooler's context holds
        an RPN point (reference double_stage_detector.py:194-198), IoU
        assignment with the subsampling draws `uniforms`, then the first
        MINIBATCH_NUM proposals with any target, in index order."""
        proposals, _, prop_valid = self.rpn_spec.propose(rpn_sg)
        ctx = query_boxes_3d_mask(rpn_sg["base_xyz"],
                                  expand_boxes(proposals, self.pool_context)).amax(-1)
        valid = (ctx.float() * prop_valid.float())[..., None]
        ctr = boxes_bottom_to_center(proposals)[..., 0:3]
        targets = assign_targets(self.assigner_2, ctr, proposals[:, :, None, :], gt_boxes,
                                 gt_labels, valid_mask=valid, uniforms=uniforms)
        selected = (targets["pmask"] + targets["nmask"]).amax(-1) > 0
        kept = gather_tree_by_mask(
            {"proposals": proposals, "pmask": targets["pmask"], "nmask": targets["nmask"],
             "gt_cls": targets["gt_cls"], "gt_boxes": targets["gt_boxes"]},
            selected, self.minibatch)
        return kept.pop("proposals"), kept

    def train_step(self, state: TrainState, batch: dict, seed: int = 0,
                   uniforms: torch.Tensor | None = None) -> dict:
        """One optimizer step (`optimizer_step`). Stage 2's minibatch draws
        ([bs, 2, proposals] uniforms: each scan's positive and negative
        subsets) are `uniforms` where given, else drawn from a generator on
        the batch's device seeded by (seed, step), so that a resumed run
        draws what the unbroken run drew; under data parallelism for the
        global batch, this rank keeping its rows."""
        if uniforms is None and not self.only_first_stage \
                and self.assigner_2.minibatch_size != -1:
            points = batch["points"]
            gen = torch.Generator(device=points.device).manual_seed((seed << 32) + state.step)
            uniforms = dp.local_rows(torch.rand(points.shape[0] * world(), 2,
                                                self.rpn_spec.max_output, generator=gen,
                                                device=points.device))
        losses = state.parallel or self.compute_losses
        return optimizer_step(state, self.solver_cfg,
                              lambda bn_m: losses(batch, bn_m, uniforms))
