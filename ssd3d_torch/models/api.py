"""Model construction and inference dispatch by MODEL.TYPE (counterpart of
`ssd3d/models/api.py`, the reference's modeling/__init__.py choose_model):
`build_pipeline(cfg).infer(points)` runs 3DSSD (SingleStage) or PointRCNN
(DoubleStage) end to end on a batch of scans, and `.graph` is the model's
train step (`TrainGraph` or `TwoStageGraph`). Unlike the JAX package's,
`infer` takes the points only: the weights live in the module. `infer`
calls the pipeline's `inference` module, which `bin.export` traces: one
body for both."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ssd3d_torch.models.single_stage import build_detector
from ssd3d_torch.models.two_stage import build_two_stage, foreground_mask
from ssd3d_torch.train.train_step import TrainGraph
from ssd3d_torch.train.two_stage_step import TwoStageGraph
from ssd3d_torch.utils.profiling import span


class SingleStageInference(torch.nn.Module):
    """A single-stage model's inference as a module: forward, decode and
    NMS. `Pipeline.infer` calls it and `bin.export` traces it."""

    def __init__(self, model: torch.nn.Module, spec):
        super().__init__()
        self.model = model
        self.spec = spec

    def forward(self, points: torch.Tensor) -> dict:
        """points [bs, n, 4] -> detections (boxes, scores, classes, valid,
        index; with the nuScenes heads velocity and attribute too)."""
        outputs = self.model(points)
        with span("ssd3d.decode"):
            return self.spec.decode_and_nms(outputs)


class TwoStageInference(torch.nn.Module):
    """A two-stage model's inference as a module: the RPN, the proposals,
    the RCNN over chunks of proposals (TEST.RCNN_INFER_CHUNK bounds the
    pooled tensors' memory) and the final NMS."""

    def __init__(self, model: torch.nn.Module, rpn_spec, rcnn_spec, only_first: bool,
                 chunk_limit: int):
        super().__init__()
        self.model = model
        self.rpn_spec = rpn_spec
        self.rcnn_spec = rcnn_spec
        self.only_first = only_first
        self.chunk_limit = chunk_limit

    def forward(self, points: torch.Tensor) -> dict:
        """points [bs, n, 4] -> detections (boxes, scores, classes, valid,
        index) and the RPN's proposals and proposals_valid, as the JAX
        package's DoubleStage `infer` returns them."""
        model = self.model
        rpn_out = model.rpn(points)
        with span("ssd3d.proposals"):
            proposals, scores, valid = self.rpn_spec.propose(rpn_out)
            if self.only_first:
                return {"boxes": proposals, "scores": scores,
                        "classes": torch.zeros(scores.shape, dtype=torch.int32,
                                               device=scores.device),
                        "valid": valid}
            mask = foreground_mask(rpn_out)
        p = proposals.shape[1]
        chunk = rcnn_chunk(p, self.chunk_limit)
        parts = [model.rcnn(rpn_out["base_xyz"], rpn_out["feature"], mask,
                            proposals[:, c0:c0 + chunk]) for c0 in range(0, p, chunk)]
        with span("ssd3d.decode"):
            out = {k: torch.cat([part[k] for part in parts], dim=1) for k in parts[0]}
            out["proposals"] = proposals
            dets = self.rcnn_spec.final_detections(out)
        dets["proposals"] = proposals
        dets["proposals_valid"] = valid
        return dets


@dataclasses.dataclass(frozen=True)
class Pipeline:
    """The module, `infer(points) -> detection dict` (the `inference`
    module under `torch.inference_mode`), the train graph, the class list,
    and the stage specs: `spec` of a single-stage model, `rpn_spec` and
    `rcnn_spec` of a two-stage one."""

    model: torch.nn.Module
    inference: torch.nn.Module
    graph: Any
    cls_list: tuple
    spec: Any = None
    rpn_spec: Any = None
    rcnn_spec: Any = None

    @torch.inference_mode()
    def infer(self, points: torch.Tensor) -> dict:
        with span("ssd3d.infer"):
            return self.inference(points)


def rcnn_chunk(p: int, limit: int) -> int:
    """Proposals per RCNN pass: the largest divisor of p that is at most
    `limit` (TEST.RCNN_INFER_CHUNK; 0 means all at once)."""
    if not limit:
        return p
    return max(d for d in range(1, min(limit, p) + 1) if p % d == 0)


def build_pipeline(cfg, nms_pre_topk: int = 2048, device: torch.device | str = "cuda") -> Pipeline:
    """Config -> Pipeline on `device` (the card by default; without one it
    raises), in eval mode. Weights are left as constructed: fill them with
    `entry.init_weights`, a state dict or a checkpoint."""
    if cfg.MODEL.TYPE != "DoubleStage":
        model, spec = build_detector(cfg, device=device)
        return Pipeline(model, SingleStageInference(model, spec),
                        TrainGraph.build(cfg, model, spec), spec.cls_list, spec=spec)

    model, rpn_spec, rcnn_spec = build_two_stage(cfg, nms_pre_topk=nms_pre_topk, device=device)
    inference = TwoStageInference(model, rpn_spec, rcnn_spec, cfg.MODEL.ONLY_FIRST_STAGE,
                                  cfg.TEST.RCNN_INFER_CHUNK)
    return Pipeline(model, inference, TwoStageGraph.build(cfg, model, rpn_spec, rcnn_spec),
                    rpn_spec.cls_list, rpn_spec=rpn_spec, rcnn_spec=rcnn_spec)
