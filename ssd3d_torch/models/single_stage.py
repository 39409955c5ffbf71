"""3DSSD single-stage detector (counterpart of
`ssd3d/models/single_stage.py`).

`SingleStageDetector` is the parametric graph (backbone + heads);
`DetectorSpec.decode_and_nms` turns its outputs into at most `max_output`
boxes per class and scan. `build_detector(cfg, device)` wires both from a
config tree (`ssd3d_torch.config` or the JAX package's, both attribute-access
dicts of the same keys), as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch
from torch import nn

from ssd3d_torch.core.box_coders import AnchorGenerator, BoxCoder
from ssd3d_torch.core.geometry import boxes_to_bev_aabb
from ssd3d_torch.models.backbone import PointBackbone
from ssd3d_torch.models.heads import DetectionHead, IoUHead
from ssd3d_torch.ops import _build
from ssd3d_torch.ops.nms import batched_class_nms
from ssd3d_torch.utils.profiling import span


class SingleStageDetector(nn.Module):
    """Backbone + detection and IoU heads, config-driven. Head modules are
    named after their scope, or `head{i}` when it is empty, as in flax."""

    def __init__(self, architecture: Sequence[Sequence[Any]],
                 head_cfg: Sequence[Sequence[Any]], in_channels: int,
                 max_translate_range: Sequence[float], num_classes: int,
                 num_angle_cls: int, reg_base: int, reg_channels: int,
                 cls_activation: str = "Sigmoid",
                 aggregation_sa_feature: bool = False,
                 compute_dtype: torch.dtype | None = None,
                 predict_attr_velo: bool = False, use_gn: bool = False):
        super().__init__()
        self.backbone = PointBackbone(architecture, in_channels, max_translate_range,
                                      aggregation_sa_feature, compute_dtype, use_gn=use_gn)
        cls_channels = num_classes if cls_activation == "Sigmoid" else num_classes + 1
        self.heads: list[tuple] = []  # (name, xyz sources, feature sources)
        self.iou_heads: list[tuple] = []  # (name, feature sources)
        for i, (xyz_idx, feat_idx, _op, mlp, bn, head_type, scope) in enumerate(head_cfg):
            name = scope if scope else f"head{i}"
            c_in = sum(self.backbone.feature_channels[j] for j in feat_idx)
            if head_type == "Det":
                self.add_module(name, DetectionHead(
                    c_in, mlp, cls_channels, reg_base, reg_channels, num_angle_cls,
                    bn=bn, compute_dtype=compute_dtype, predict_attr_velo=predict_attr_velo,
                    use_gn=use_gn,
                ))
                self.heads.append((name, xyz_idx, feat_idx))
            elif head_type == "IoU":
                self.add_module(name, IoUHead(c_in, mlp, num_classes, bn=bn,
                                              compute_dtype=compute_dtype, use_gn=use_gn))
                self.iou_heads.append((name, feat_idx))
            else:
                raise ValueError(f"unknown head type {head_type!r}")

    def forward(self, points: torch.Tensor, bn_momentum: float = 0.9) -> dict:
        """points: [bs, n, 3 + c] -> dict of raw network outputs. In train
        mode BatchNorm uses batch statistics and moves its running ones by
        `bn_momentum`."""
        with span("ssd3d.backbone"):
            net = self.backbone(points, bn_momentum)
        with span("ssd3d.head"):
            return self.predict(net, bn_momentum)

    def predict(self, net: dict, bn_momentum: float = 0.9) -> dict:
        """The heads over the backbone's output lists (`backbone(points)`),
        for callers that also inspect those lists."""
        out: dict = {"vote_base": net["vote_base"], "vote_offset": net["vote_offset"],
                     "fps_idx": net["fps_idx"]}
        det_xyz, det_preds = [], []
        for name, xyz_idx, feat_idx in self.heads:
            xyz_in = torch.cat([net["xyz"][j] for j in xyz_idx], dim=1)
            feat_in = torch.cat([net["features"][j] for j in feat_idx], dim=1)
            det_preds.append(getattr(self, name)(feat_in, bn_momentum))
            det_xyz.append(xyz_in)
        out["base_xyz"] = torch.cat(det_xyz, dim=1)
        for key in ("feature", "cls", "offset", "angle_cls", "angle_res", "attribute",
                    "velocity"):
            if key in det_preds[0]:
                out[key] = torch.cat([p[key] for p in det_preds], dim=1)
        if self.iou_heads:
            out["iou"] = torch.cat(
                [getattr(self, name)(torch.cat([net["features"][j] for j in feat_idx], dim=1),
                                     bn_momentum) for name, feat_idx in self.iou_heads], dim=1)
        return out


@dataclasses.dataclass(frozen=True)
class DetectorSpec:
    """Static companion of the detector: codec, anchors, NMS parameters."""

    cls_list: tuple
    coder: BoxCoder
    anchors: AnchorGenerator
    cls_activation: str
    max_output: int
    nms_threshold: float
    has_iou_head: bool = False

    def decode(self, outputs: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """Raw head outputs -> every candidate's (boxes [b, n, cls, 7],
        scores [b, n, cls]), before NMS; with an IoU head the scores are
        the class scores times the predicted IoU."""
        base_xyz = outputs["base_xyz"]
        boxes = self.coder.decode(base_xyz, outputs["offset"], outputs["angle_cls"],
                                  outputs["angle_res"], self.anchors(base_xyz))
        if self.cls_activation == "Softmax":
            score = torch.softmax(outputs["cls"], dim=-1)[..., 1:]
        else:
            score = torch.sigmoid(outputs["cls"])
        if self.has_iou_head:
            score = score * outputs["iou"]
        return boxes, score

    def decode_and_nms(self, outputs: dict) -> dict:
        """Raw head outputs -> final detections (boxes, scores, classes,
        valid, index; each [b, cls * max_output, ...]). With the nuScenes
        heads also each kept box's velocity [.., 2] and attribute logits
        [.., 8]: its source point's, from its class's regression slot (slot
        0 of an anchor-free head)."""
        boxes, score = self.decode(outputs)
        bev = boxes_to_bev_aabb(boxes)
        det = batched_class_nms(boxes, bev, score, self.max_output, self.nms_threshold)
        for key in ("velocity", "attribute"):
            if key in outputs:
                arr = outputs[key]  # [b, n, reg_base, c]
                rows = torch.arange(arr.shape[0], device=arr.device)[:, None]
                slot = det["classes"].long().clamp(max=arr.shape[2] - 1)
                det[key] = arr[rows, det["index"].long(), slot]
        return det


def dataset_classes(cfg) -> tuple:
    """The detected classes of the config's dataset (DATASET.TYPE KITTI or
    NuScenes), in head order."""
    if cfg.DATASET.TYPE.upper() == "NUSCENES":
        return tuple(cfg.DATASET.NUSCENES.CLS_LIST)
    return tuple(cfg.DATASET.KITTI.CLS_LIST)


def point_feature_channels(cfg) -> int:
    """Per-point feature channels after xyz: KITTI's reflectance, or the
    nuScenes sweeps' (intensity and) time lag (INPUT_FEATURE_CHANNEL - 3)."""
    if cfg.DATASET.TYPE.upper() == "NUSCENES":
        return cfg.DATASET.NUSCENES.INPUT_FEATURE_CHANNEL - 3
    return 1


def build_detector(cfg, stage: str = "FIRST_STAGE", device: torch.device | str = "cuda"):
    """Config -> (module on `device`, in eval mode, spec). Weights are left
    as constructed; `ssd3d_torch.entry.init_weights` or a converted state
    dict fills them. The default device is the card; without one it raises
    (pass device="cpu" for the plain versions)."""
    device = _build.resolve_device(device)
    stage_cfg = cfg.MODEL[stage]
    net_cfg = cfg.MODEL.NETWORK[stage]
    cls_list = dataset_classes(cfg)
    reg_method = stage_cfg.REGRESSION_METHOD.TYPE
    coder = BoxCoder(reg_method, cfg.MODEL.ANGLE_CLS_NUM,
                     half_range=stage_cfg.REGRESSION_METHOD.HALF_BIN_SEARCH_RANGE,
                     num_bins=stage_cfg.REGRESSION_METHOD.BIN_CLASS_NUM)
    anchors = AnchorGenerator(cfg.DATASET.TYPE, cls_list, reg_method)
    compute_dtype = torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" else None
    module = SingleStageDetector(
        architecture=[list(layer) for layer in net_cfg.ARCHITECTURE],
        head_cfg=[list(h) for h in net_cfg.HEAD],
        in_channels=point_feature_channels(cfg),
        max_translate_range=list(cfg.MODEL.MAX_TRANSLATE_RANGE),
        num_classes=len(cls_list),
        num_angle_cls=cfg.MODEL.ANGLE_CLS_NUM,
        reg_base=1 if reg_method.endswith("free") else len(cls_list),
        reg_channels=coder.reg_channels,
        cls_activation=stage_cfg.CLS_ACTIVATION,
        aggregation_sa_feature=cfg.MODEL.NETWORK.AGGREGATION_SA_FEATURE,
        compute_dtype=compute_dtype,
        predict_attr_velo=stage_cfg.PREDICT_ATTRIBUTE_AND_VELOCITY,
        use_gn=bool(cfg.MODEL.NETWORK.USE_GN),
    ).to(device).eval()
    spec = DetectorSpec(
        cls_list=cls_list,
        coder=coder,
        anchors=anchors,
        cls_activation=stage_cfg.CLS_ACTIVATION,
        max_output=stage_cfg.MAX_OUTPUT_NUM,
        nms_threshold=stage_cfg.NMS_THRESH,
        has_iou_head=any(h[5] == "IoU" for h in net_cfg.HEAD),
    )
    return module, spec
