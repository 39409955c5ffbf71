"""PointRCNN / STD two-stage detector (counterpart of
`ssd3d/models/two_stage.py`).

Stage 1 (RPN): a PointNet++ encoder-decoder over the raw scan, a per-point
Bin-Anchor head, class-unaware NMS into a fixed buffer of proposals. Stage 2
(RCNN): the RoI pooler gathers the first 512 RPN points inside each
expanded proposal with their features, in the proposal's frame: PointRCNN's
`RegionPool` hands those points to the RCNN, STD's `PointsPool` voxelises
them (a 6 x 6 x 6 grid in `configs/kitti/std`) and hands over the voxel
centres with their pooled features. A small SA stack runs over batch x
proposals such clouds (its SA layers take the fused kernel K7), and a head
refines each proposal.

Submodules carry the flax scope names (`rpn_backbone`, `rpn_head`,
`roi_pool.align`, `roi_pool.vfe`, `rcnn_backbone`, `rcnn_head`), so a flax
variable tree converts with `utils.convert.flax_to_state_dict` and loads
strictly. In train mode (`module.train()`) `rpn` and `rcnn` are the stages
of `train.two_stage_step.TwoStageGraph`.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from ssd3d_torch.core.box_coders import AnchorGenerator, BoxCoder
from ssd3d_torch.core.geometry import boxes_bottom_to_center, boxes_to_bev_aabb, rotate_points_y
from ssd3d_torch.models.backbone import PointBackbone
from ssd3d_torch.models.heads import DetectionHead
from ssd3d_torch.models.single_stage import dataset_classes, point_feature_channels
from ssd3d_torch.nn.layers import SharedMLP, max_pool
from ssd3d_torch.ops import _build
from ssd3d_torch.ops.grouping import _first_k, gather_rows, group_points, query_boxes_3d_points
from ssd3d_torch.ops.nms import batched_class_nms, class_unaware_nms
from ssd3d_torch.utils.profiling import span


def expand_boxes(boxes: torch.Tensor, context: float) -> torch.Tensor:
    """Grow l, h and w by the context range."""
    return torch.cat([boxes[..., 0:3], boxes[..., 3:6] + context, boxes[..., 6:7]], dim=-1)


def canonicalize_pool(pool_xyz: torch.Tensor, proposals: torch.Tensor) -> torch.Tensor:
    """pool_xyz: [bs, p, ns, 3]; proposals: [bs, p, 7] -> each proposal's frame."""
    return rotate_points_y(pool_xyz - proposals[:, :, None, 0:3], -proposals[..., 6])


class RegionPool(nn.Module):
    """PointRCNN RoI pooling: the first `sample_pts_num` RPN points inside
    each proposal grown by `context_range`, as (canonical xyz, `align` MLP
    over canonical xyz and the info keys, RPN features)."""

    def __init__(self, feature_channels: int, sample_pts_num: int, context_range: float,
                 info_keys: Sequence[str], align_channels: Sequence[int], bn: bool = True,
                 compute_dtype: torch.dtype | None = None, use_gn: bool = False):
        super().__init__()
        self.sample_pts_num = sample_pts_num
        self.context_range = context_range
        self.info_keys = [k for k in info_keys if k in ("mask", "dist")]
        self.align = SharedMLP(3 + len(self.info_keys), align_channels, bn=bn,
                               compute_dtype=compute_dtype, use_gn=use_gn)
        self.out_channels = 3 + self.align.out_channels + feature_channels

    def forward(self, base_xyz, base_feature, base_mask, proposals, bn_momentum: float = 0.9):
        """base_*: [bs, pts, *]; proposals: [bs, p, 7] -> (pooled
        [bs * p, ns, out_channels], has-points mask int32 [bs, p, 1])."""
        expanded = expand_boxes(proposals, self.context_range)
        idx, cnt = query_boxes_3d_points(base_xyz, expanded, self.sample_pts_num)
        has = (cnt > 0).to(torch.int32)[..., None]
        idx = idx * has
        pool_xyz = group_points(base_xyz, idx)  # [bs, p, ns, 3]
        pool_feat = group_points(base_feature, idx)
        info = []
        for key in self.info_keys:
            if key == "mask":
                info.append(group_points(base_mask, idx))
            else:  # dist: |xyz| of the pooled point, sqrt of the summed squares
                info.append(pool_xyz.square().sum(-1, keepdim=True).sqrt())
        canonical = canonicalize_pool(pool_xyz, expanded)
        encoded = self.align(torch.cat([canonical] + info, dim=-1), bn_momentum)
        out = torch.cat([canonical, encoded, pool_feat], dim=-1)
        bs, p, ns, c = out.shape
        return out.reshape(bs * p, ns, c), has


class PointsPool(nn.Module):
    """STD's RoI pooler: the first `sample_pts_num` RPN points inside each
    proposal grown by `context_range`, in the proposal's frame, scattered
    into an l x h x w voxel grid (the first `vox_k` points of each voxel, in
    index order, padded by the first), each point given its offset from its
    voxel's centre, the `align` and `vfe` MLPs over them, and a max-pool a
    voxel masked where the voxel is empty. Returns the voxel centres (in the
    proposal's frame) with the pooled features, one row a voxel."""

    def __init__(self, feature_channels: int, sample_pts_num: int, context_range: float,
                 info_keys: Sequence[str], align_channels: Sequence[int], grid: Sequence[int],
                 vfe_channels: Sequence[int], bn: bool = True,
                 compute_dtype: torch.dtype | None = None, use_gn: bool = False):
        super().__init__()
        self.sample_pts_num = sample_pts_num
        self.context_range = context_range
        self.info_keys = [k for k in info_keys if k in ("mask", "dist")]
        self.grid = tuple(int(g) for g in grid)  # (l, h, w, points a voxel)
        # each gathered point: canonical xyz, the info keys, the RPN
        # features, then its offset from its voxel's centre
        point_channels = 3 + len(self.info_keys) + feature_channels + 3
        self.align = SharedMLP(point_channels, align_channels, bn=bn, compute_dtype=compute_dtype,
                               use_gn=use_gn)
        self.vfe = SharedMLP(self.align.out_channels, vfe_channels, bn=bn,
                             compute_dtype=compute_dtype, use_gn=use_gn)
        self.out_channels = 3 + self.vfe.out_channels

    def voxel_ids(self, canonical: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
        """canonical [bs, p, ns, 3] in boxes of size [bs, p, 3] (l, h, w) ->
        each point's voxel int32 [bs, p, ns]: x in [-l/2, l/2], y in [-h, 0]
        and z in [-w/2, w/2] scaled to the grid, truncated, then clamped,
        in the JAX package's order of operations (a point on a voxel face
        goes where the reference puts it)."""
        gl, gh, gw, _ = self.grid
        fx = (canonical[..., 0] / size[..., None, 0] + 0.5) * gl
        fy = (canonical[..., 1] / size[..., None, 1] + 1.0) * gh
        fz = (canonical[..., 2] / size[..., None, 2] + 0.5) * gw
        vx = fx.to(torch.int32).clamp(0, gl - 1)
        vy = fy.to(torch.int32).clamp(0, gh - 1)
        vz = fz.to(torch.int32).clamp(0, gw - 1)
        return (vx * gh + vy) * gw + vz

    def unit_centres(self, device: torch.device) -> torch.Tensor:
        """The voxel centres in the unit box, [l * h * w, 3], voxel v =
        (x * h + y) * w + z: (i + 0.5) / g - 0.5 (- 1.0 for y), each step
        rounded to f32, as XLA folds the JAX package's constant expression.
        Computed on the CPU and then moved: on the card PyTorch divides a
        tensor by a number as a product with its reciprocal, which rounds
        otherwise, and the ties between the centres' distances (the RCNN's
        D-FPS) would fall another way."""
        gl, gh, gw, _ = self.grid
        ii = torch.arange(gl * gh * gw, dtype=torch.int32)
        cx = ((ii // (gh * gw)).float() + 0.5) / gl - 0.5
        cy = (((ii // gw) % gh).float() + 0.5) / gh - 1.0
        cz = ((ii % gw).float() + 0.5) / gw - 0.5
        return torch.stack([cx, cy, cz], dim=-1).to(device)

    def forward(self, base_xyz, base_feature, base_mask, proposals, bn_momentum: float = 0.9):
        """base_*: [bs, pts, *]; proposals: [bs, p, 7] -> (pooled [bs * p,
        l * h * w, out_channels], has-points mask int32 [bs, p, 1])."""
        gl, gh, gw, vox_k = self.grid
        nvox = gl * gh * gw
        expanded = expand_boxes(proposals, self.context_range)
        idx, cnt = query_boxes_3d_points(base_xyz, expanded, self.sample_pts_num)
        has = (cnt > 0).to(torch.int32)[..., None]
        idx = idx * has
        pool_xyz = group_points(base_xyz, idx)  # [bs, p, ns, 3]
        pool_feat = group_points(base_feature, idx)
        info = []
        for key in self.info_keys:
            if key == "mask":
                info.append(group_points(base_mask, idx))
            else:  # dist: |xyz| of the pooled point
                info.append(pool_xyz.square().sum(-1, keepdim=True).sqrt())
        canonical = canonicalize_pool(pool_xyz, expanded)
        bs, p, ns, _ = canonical.shape
        size = expanded[..., 3:6]
        vox_id = self.voxel_ids(canonical, size).reshape(bs * p, ns)
        # the first vox_k points of each voxel, by the first-k of the ball query
        valid = vox_id[:, None, :] == torch.arange(nvox, dtype=torch.int32,
                                                   device=vox_id.device)[None, :, None]
        sel_idx, sel_cnt = _first_k(valid, vox_k)  # [bs * p, nvox, vox_k], [bs * p, nvox]
        feats = torch.cat([canonical] + info + [pool_feat], dim=-1).reshape(bs * p, ns, -1)
        gathered = gather_rows(feats, sel_idx.reshape(bs * p, nvox * vox_k))
        gathered = gathered.reshape(bs * p, nvox, vox_k, -1)
        vox_has = (sel_cnt > 0).to(feats.dtype)[..., None]  # [bs * p, nvox, 1]
        vox_ctrs = (self.unit_centres(canonical.device)[None, None]
                    * size[..., None, :]).reshape(bs * p, nvox, 3)
        pillar = gathered[..., 0:3] - vox_ctrs[:, :, None, :]
        encoded = self.vfe(self.align(torch.cat([gathered, pillar], dim=-1), bn_momentum),
                           bn_momentum)
        dense = max_pool(encoded) * vox_has  # [bs * p, nvox, c]
        return torch.cat([vox_ctrs, dense], dim=-1), has


class TwoStageDetector(nn.Module):
    """RPN + RCNN; the stages are methods (`rpn`, `rcnn`) so that inference
    can run the RCNN over chunks of proposals and training can assign and
    subsample the proposals between them."""

    def __init__(self, rpn_architecture, rpn_head_cfg, rcnn_architecture, rcnn_head_cfg,
                 pooler_cfg, max_translate_range, num_angle_cls: int,
                 rpn_cls_channels: int, rpn_reg_base: int, rpn_reg_channels: int,
                 rcnn_cls_channels: int, rcnn_reg_base: int, rcnn_reg_channels: int,
                 aggregation_sa_feature: bool = False, compute_dtype: torch.dtype | None = None,
                 in_channels: int = 1, use_gn: bool = False):
        super().__init__()
        self.use_gn = use_gn
        self.rpn_backbone = PointBackbone(rpn_architecture, in_channels, max_translate_range,
                                          aggregation_sa_feature, compute_dtype, use_gn=use_gn)
        rpn_ch = self.rpn_backbone.feature_channels
        self.rpn_heads = self._heads(rpn_head_cfg, rpn_ch, "rpn_head", rpn_cls_channels,
                                     rpn_reg_base, rpn_reg_channels, num_angle_cls, compute_dtype)
        head_feat = getattr(self, self.rpn_heads[0][0]).trunk.out_channels  # rpn "feature"
        self.pool_name = pooler_cfg[8] or "roi_pool"
        pool_args = (head_feat, pooler_cfg[3], pooler_cfg[4], pooler_cfg[1], pooler_cfg[2])
        if pooler_cfg[0] == "RegionPool":
            pooler = RegionPool(*pool_args, bn=pooler_cfg[7], compute_dtype=compute_dtype,
                                use_gn=use_gn)
        elif pooler_cfg[0] == "PointsPool":
            pooler = PointsPool(*pool_args, grid=pooler_cfg[5], vfe_channels=pooler_cfg[6],
                                bn=pooler_cfg[7], compute_dtype=compute_dtype, use_gn=use_gn)
        else:
            raise ValueError(f"unknown RoI pooler {pooler_cfg[0]!r}")
        self.add_module(self.pool_name, pooler)
        # the RCNN's lists start with the proposal centres (no features)
        self.rcnn_backbone = PointBackbone(rcnn_architecture, pooler.out_channels - 3,
                                           max_translate_range, aggregation_sa_feature,
                                           compute_dtype, prefix_channels=(0,), use_gn=use_gn)
        self.rcnn_heads = self._heads(rcnn_head_cfg, self.rcnn_backbone.feature_channels,
                                      "rcnn_head", rcnn_cls_channels, rcnn_reg_base,
                                      rcnn_reg_channels, num_angle_cls, compute_dtype)

    def _heads(self, head_cfg, feat_ch, prefix, cls_ch, reg_base, reg_ch, num_angle_cls,
               compute_dtype):
        heads = []
        for i, (xyz_idx, feat_idx, _op, mlp, bn, head_type, scope) in enumerate(head_cfg):
            # the JAX package's two-stage model builds detection heads only
            assert head_type == "Det", f"two-stage {head_type} heads are not used by any config"
            name = scope or f"{prefix}{i}"
            self.add_module(name, DetectionHead(sum(feat_ch[j] for j in feat_idx), mlp, cls_ch,
                                                reg_base, reg_ch, num_angle_cls, bn=bn,
                                                compute_dtype=compute_dtype, use_gn=self.use_gn))
            heads.append((name, xyz_idx, feat_idx))
        return heads

    def _predict(self, heads, net, bn_momentum, fold=None) -> dict:
        preds, xyzs = [], []
        for name, xyz_idx, feat_idx in heads:
            xyz_in = torch.cat([net["xyz"][j] for j in xyz_idx], dim=1)
            feat_in = torch.cat([net["features"][j] for j in feat_idx], dim=1)
            if fold is not None and feat_in.shape[0] != fold[0]:
                feat_in = feat_in.reshape(*fold, -1)  # pooled [bs * p, c] -> [bs, p, c]
            preds.append(getattr(self, name)(feat_in, bn_momentum))
            xyzs.append(xyz_in)
        out = {"base_xyz": torch.cat(xyzs, dim=1)}
        for key in ("feature", "cls", "offset", "angle_cls", "angle_res"):
            out[key] = torch.cat([p[key] for p in preds], dim=1)
        return out

    def rpn(self, points: torch.Tensor, bn_momentum: float = 0.9) -> dict:
        """points [bs, n, 4] -> the RPN's per-point outputs."""
        with span("ssd3d.rpn"):
            net = self.rpn_backbone(points, bn_momentum)
            out = self._predict(self.rpn_heads, net, bn_momentum)
            out["vote_base"], out["vote_offset"] = net["vote_base"], net["vote_offset"]
            return out

    def rcnn(self, base_xyz, base_feature, base_mask, proposals, bn_momentum: float = 0.9) -> dict:
        """proposals [bs, p, 7] (bottom-face boxes) -> per-proposal
        refinement outputs [bs, p, ...] and the pool's has-points mask."""
        bs, p = proposals.shape[:2]
        with span("ssd3d.rcnn"):
            with span("ssd3d.rcnn.pool"):
                pool_out, pool_mask = getattr(self, self.pool_name)(
                    base_xyz, base_feature, base_mask, proposals, bn_momentum)
            ctr = boxes_bottom_to_center(proposals)[..., 0:3]
            net = self.rcnn_backbone(pool_out, bn_momentum, prefix_xyz=(ctr,),
                                     prefix_features=(None,))
            out = self._predict(self.rcnn_heads, net, bn_momentum, fold=(bs, p))
            out["pool_mask"] = pool_mask
            return out

    def forward(self, points: torch.Tensor, rpn_spec: "StageSpec", bn_momentum: float = 0.9):
        """The whole test-mode forward: RPN, proposals, RCNN."""
        rpn_out = self.rpn(points, bn_momentum)
        proposals, scores, valid = rpn_spec.propose(rpn_out)
        out = self.rcnn(rpn_out["base_xyz"], rpn_out["feature"], foreground_mask(rpn_out),
                        proposals, bn_momentum)
        out.update(proposals=proposals, proposal_scores=scores, proposal_valid=valid, rpn=rpn_out)
        return out


def foreground_mask(rpn_out: dict) -> torch.Tensor:
    """The RoI pool's mask channel: 1.0 where the RPN's best class
    probability is at least 0.5, [bs, n, 1] f32."""
    return (torch.sigmoid(rpn_out["cls"].amax(-1, keepdim=True)) >= 0.5).float()


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One stage's codec, anchors and post-processing."""

    cls_list: tuple
    coder: BoxCoder
    anchors: AnchorGenerator
    cls_activation: str
    max_output: int
    nms_threshold: float
    nms_pre_topk: int = 0

    def decode(self, outputs: dict) -> torch.Tensor:
        return self.coder.decode(outputs["base_xyz"], outputs["offset"], outputs["angle_cls"],
                                 outputs["angle_res"], self.anchors(outputs["base_xyz"]))

    def scores(self, outputs: dict) -> torch.Tensor:
        if self.cls_activation == "Softmax":
            return torch.softmax(outputs["cls"], dim=-1)[..., 1:]
        return torch.sigmoid(outputs["cls"])

    def propose(self, outputs: dict):
        """RPN outputs -> (proposals [bs, max_output, 7], scores, valid)."""
        return class_unaware_nms(self.decode(outputs), self.scores(outputs), self.max_output,
                                 self.nms_threshold, pre_topk=self.nms_pre_topk)


@dataclasses.dataclass(frozen=True)
class ProposalSpec(StageSpec):
    """The RCNN's spec: its anchors are the proposals in the outputs."""

    def decode(self, outputs: dict) -> torch.Tensor:
        ctr = boxes_bottom_to_center(outputs["proposals"])[..., 0:3]
        return self.coder.decode(ctr, outputs["offset"], outputs["angle_cls"],
                                 outputs["angle_res"], outputs["proposals"][:, :, None, :])

    def final_detections(self, outputs: dict) -> dict:
        boxes = self.decode(outputs)
        score = self.scores(outputs)
        if "pool_mask" in outputs:
            score = score * outputs["pool_mask"].to(score.dtype)
        return batched_class_nms(boxes, boxes_to_bev_aabb(boxes), score, self.max_output,
                                 self.nms_threshold)


def _stage_fields(cfg, stage: str, cls_list, nms_pre_topk: int = 0) -> dict:
    sc = cfg.MODEL[stage]
    method = sc.REGRESSION_METHOD.TYPE
    return dict(
        cls_list=tuple(cls_list),
        coder=BoxCoder(method, cfg.MODEL.ANGLE_CLS_NUM,
                       half_range=sc.REGRESSION_METHOD.HALF_BIN_SEARCH_RANGE,
                       num_bins=sc.REGRESSION_METHOD.BIN_CLASS_NUM),
        anchors=AnchorGenerator(cfg.DATASET.TYPE, cls_list, method),
        cls_activation=sc.CLS_ACTIVATION,
        max_output=sc.MAX_OUTPUT_NUM,
        nms_threshold=sc.NMS_THRESH,
        nms_pre_topk=nms_pre_topk,
    )


def build_two_stage(cfg, nms_pre_topk: int = 2048, device: torch.device | str = "cuda"):
    """Config -> (TwoStageDetector on `device` in eval mode, rpn_spec,
    rcnn_spec). Weights are left as constructed (`entry.init_weights` or a
    converted state dict fills them). The default device is the card."""
    device = _build.resolve_device(device)
    cls_list = dataset_classes(cfg)
    rpn_spec = StageSpec(**_stage_fields(cfg, "FIRST_STAGE", cls_list, nms_pre_topk))
    rcnn_spec = ProposalSpec(**_stage_fields(cfg, "SECOND_STAGE", cls_list))
    s1, s2 = cfg.MODEL.FIRST_STAGE, cfg.MODEL.SECOND_STAGE

    def cls_ch(stage_cfg):
        return len(cls_list) if stage_cfg.CLS_ACTIVATION == "Sigmoid" else len(cls_list) + 1

    def reg_base(stage_cfg):
        return 1 if stage_cfg.REGRESSION_METHOD.TYPE.endswith("free") else len(cls_list)

    net = cfg.MODEL.NETWORK
    model = TwoStageDetector(
        rpn_architecture=[list(layer) for layer in net.FIRST_STAGE.ARCHITECTURE],
        rpn_head_cfg=[list(h) for h in net.FIRST_STAGE.HEAD],
        rcnn_architecture=[list(layer) for layer in net.SECOND_STAGE.ARCHITECTURE],
        rcnn_head_cfg=[list(h) for h in net.SECOND_STAGE.HEAD],
        pooler_cfg=list(net.FIRST_STAGE.POINTS_POOLER),
        max_translate_range=list(cfg.MODEL.MAX_TRANSLATE_RANGE),
        num_angle_cls=cfg.MODEL.ANGLE_CLS_NUM,
        rpn_cls_channels=cls_ch(s1), rpn_reg_base=reg_base(s1),
        rpn_reg_channels=rpn_spec.coder.reg_channels,
        rcnn_cls_channels=cls_ch(s2), rcnn_reg_base=reg_base(s2),
        rcnn_reg_channels=rcnn_spec.coder.reg_channels,
        aggregation_sa_feature=net.AGGREGATION_SA_FEATURE,
        compute_dtype=torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" else None,
        in_channels=point_feature_channels(cfg),
        use_gn=bool(cfg.MODEL.NETWORK.USE_GN),
    ).to(device).eval()
    return model, rpn_spec, rcnn_spec
