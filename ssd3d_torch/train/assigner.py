"""Target assignment (counterpart of `ssd3d/train/assigner.py`): the Mask
method (point-in-box membership) and the IoU method (the rotated BEV or 3D
IoU, or the point-membership IoU, of each anchor with its assigned GT box),
gated by a valid mask, with the reference's random minibatch subsampling.

Shapes (GT boxes are zero-padded to a fixed count per batch):
    points      [bs, pts, 3]
    anchors     [bs, pts, cls, 7]  (anchor-free: [bs, pts, 1, 3], the points)
    gt_boxes    [bs, gt, 7]        zero rows = padding
    gt_labels   [bs, gt]           1-based; 0 = padding

Assignment takes no gradient: its outputs are masks, indices and GT boxes.
The subsampling's random numbers come from the caller (`uniforms`), so that
a test can hand in the JAX package's own draws.
"""

from __future__ import annotations

import dataclasses

import torch

from ssd3d_torch.core.geometry import points_in_boxes
from ssd3d_torch.core.iou import boxes_iou_bev_3d
from ssd3d_torch.ops.grouping import query_points_iou

# an IoU-assigned negative overlaps its GT box by at least this much
MIN_NEG_IOU = 0.05


@dataclasses.dataclass(frozen=True)
class AssignerConfig:
    method: str  # 'Mask' | 'IoU'
    minibatch_size: int  # -1: use every point
    effective_sample_range: float  # CLASSIFICATION_LOSS.SOFTMAX_SAMPLE_RANGE
    iou_sample_type: str  # 'BEV' | '3D' | 'Point'
    positive_ratio: float
    pos_iou: float
    neg_iou: float

    @classmethod
    def from_cfg(cls, stage_cfg):
        return cls(
            method=stage_cfg.ASSIGN_METHOD,
            minibatch_size=stage_cfg.MINIBATCH_NUM,
            effective_sample_range=stage_cfg.CLASSIFICATION_LOSS.SOFTMAX_SAMPLE_RANGE,
            iou_sample_type=stage_cfg.IOU_SAMPLE_TYPE,
            positive_ratio=stage_cfg.MINIBATCH_RATIO,
            pos_iou=stage_cfg.CLASSIFICATION_POS_IOU,
            neg_iou=stage_cfg.CLASSIFICATION_NEG_IOU,
        )


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first true entry along the last axis (0 when none): the
    first maximum, as jnp.argmax returns it. argmax takes no bool."""
    return mask.to(torch.uint8).argmax(-1)


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [bs, g, ...], idx [bs, pts] -> [bs, pts, ...]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def random_subset_mask(uniform: torch.Tensor, candidate: torch.Tensor, k: torch.Tensor,
                       cap: int) -> torch.Tensor:
    """A uniform subset without replacement of min(k, |candidate|) true
    entries of each row (np.random.choice(..., replace=False) in the
    reference, gt_sampler.py:147): the candidates with the largest draws.
    uniform: [bs, n] draws in [0, 1); candidate: bool [bs, n]; k: int [bs]
    or a scalar; cap: a bound on k -> bool [bs, n].

    The order is a stable descending sort, so equal draws go to the lower
    index, as `lax.top_k` orders them. Draws are continuous: an equal pair
    is rare, and it changes the subset only where it straddles the cut."""
    n = candidate.shape[-1]
    cap = min(cap, n)
    scores = torch.where(candidate, uniform, torch.full_like(uniform, float("-inf")))
    top = scores.sort(dim=-1, descending=True, stable=True).indices[:, :cap]
    take = torch.minimum(candidate.sum(-1), torch.as_tensor(k, device=candidate.device))
    keep = torch.arange(cap, device=candidate.device) < take.reshape(-1, 1)
    return torch.zeros_like(candidate).scatter(1, top, keep) & candidate


@torch.no_grad()
def assign_targets(cfg: AssignerConfig, points: torch.Tensor, anchors: torch.Tensor,
                   gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                   valid_mask: torch.Tensor | None = None,
                   uniforms: torch.Tensor | None = None,
                   gt_velocity: torch.Tensor | None = None,
                   gt_attribute: torch.Tensor | None = None) -> dict:
    """Per-point, per-class targets (TargetAssigner.assign semantics). Each
    point takes the first GT box it lies in (box 0 when none). Mask: a point
    inside a box is positive for its class within `effective_sample_range`
    of the box's centre, a point in no box negative. IoU: an anchor is
    positive where its IoU with that box reaches `pos_iou` (and within the
    range), negative where it lies in [0.05, neg_iou). Both are gated by
    `valid_mask` [bs, pts, cls]. With a minibatch, `uniforms` [bs, 2, pts]
    holds each scan's draws for its positive and its negative subset. With
    the nuScenes labels `gt_velocity` [bs, gt, 2] and `gt_attribute` [bs,
    gt], each point also takes its assigned box's, over every class."""
    bs, pts_num, cls_num = anchors.shape[:3]
    if anchors.shape[-1] == 3:  # anchor-free: the points as zero-size boxes
        anchors = torch.cat([anchors, anchors.new_zeros(anchors.shape[:-1] + (4,))], -1)
    if valid_mask is None:
        valid_mask = torch.ones(bs, pts_num, cls_num, device=points.device)
    gt_valid = (gt_boxes != 0).any(-1)  # [bs, gt]
    inside = points_in_boxes(points, gt_boxes) & gt_valid[:, None, :]  # [bs, pts, gt]
    assigned_idx = _first_true(inside)  # [bs, pts]
    labels = _take_rows(gt_labels, assigned_idx)  # [bs, pts], 1-based
    assigned_boxes = _take_rows(gt_boxes, assigned_idx)  # [bs, pts, 7]

    dist = torch.linalg.vector_norm(anchors[..., 0:3] - assigned_boxes[:, :, None, 0:3], dim=-1)
    dist_ok = dist <= cfg.effective_sample_range  # [bs, pts, cls]
    if cls_num > 1:
        classes = torch.arange(cls_num, device=labels.device)
        label_mask = (classes == (labels - 1)[..., None]).float()
    else:
        label_mask = torch.ones(bs, pts_num, cls_num, device=points.device)
    if cfg.method == "Mask":
        fg = inside.any(-1)  # [bs, pts]
        pmask = (fg[..., None] & dist_ok).float() * label_mask * valid_mask
        nmask = (~fg)[..., None].expand(bs, pts_num, cls_num).float() * label_mask * valid_mask
    else:
        boxes = anchors.reshape(bs, pts_num * cls_num, 7)
        iou_bev, iou_3d = boxes_iou_bev_3d(boxes, gt_boxes)
        if cfg.iou_sample_type == "BEV":
            iou = iou_bev
        elif cfg.iou_sample_type == "3D":
            iou = iou_3d
        else:  # Point: the membership-count IoU, gated by the 3D IoU
            iou = query_points_iou(points, boxes, gt_boxes, iou_3d)
        iou = torch.where(gt_valid[:, None, :], iou, 0.0).reshape(bs, pts_num, cls_num, -1)
        # the IoU of each anchor with its point's assigned GT box
        iou = iou.gather(-1, assigned_idx[:, :, None, None].expand(bs, pts_num, cls_num, 1))[..., 0]
        # a class other than the assigned box's counts as ignored (-1)
        iou = iou * label_mask + (label_mask - 1.0)
        pmask = ((iou >= cfg.pos_iou) & dist_ok).float() * valid_mask
        nmask = ((iou < cfg.neg_iou) & (iou >= MIN_NEG_IOU)).float() * valid_mask
    if cfg.minibatch_size != -1:
        if uniforms is None or uniforms.shape != (bs, 2, pts_num):
            raise ValueError(f"assign_targets: a minibatch needs uniforms [{bs}, 2, {pts_num}]")
        positive_size = int(cfg.minibatch_size * cfg.positive_ratio)
        pts_p, pts_n = (pmask > 0).any(-1), (nmask > 0).any(-1)
        sel_p = random_subset_mask(uniforms[:, 0], pts_p, positive_size, cfg.minibatch_size)
        n_budget = cfg.minibatch_size - pts_p.sum(-1).clamp(max=positive_size)
        sel_n = random_subset_mask(uniforms[:, 1], pts_n, n_budget, cfg.minibatch_size)
        pmask = pmask * sel_p[..., None].float()
        nmask = nmask * sel_n[..., None].float()
    # positive points keep their class id, negatives get 0
    gt_cls = (labels[..., None] * pmask.to(labels.dtype)).sum(-1)
    out = {
        "assigned_idx": assigned_idx,
        "pmask": pmask,
        "nmask": nmask,
        "gt_cls": gt_cls.to(torch.int32),
        "gt_boxes": assigned_boxes[:, :, None, :].expand(bs, pts_num, cls_num, 7),
    }
    if gt_velocity is not None:
        out["gt_velocity"] = _take_rows(gt_velocity, assigned_idx)[:, :, None, :].expand(
            bs, pts_num, cls_num, 2)
    if gt_attribute is not None:
        out["gt_attribute"] = _take_rows(gt_attribute, assigned_idx)[:, :, None].expand(
            bs, pts_num, cls_num)
    return out


def vote_targets(vote_base: torch.Tensor, gt_boxes: torch.Tensor, expand: float = 0.1):
    """Vote-loss targets: mask = point inside any (expanded) GT box; target =
    offset from the vote base to the assigned box's volumetric centre.
    vote_base [bs, pts, 3]; gt_boxes [bs, gt, 7] -> (mask [bs, pts] f32,
    target [bs, pts, 3])."""
    with torch.no_grad():
        valid = (gt_boxes != 0).any(-1)
        inside = points_in_boxes(vote_base, gt_boxes, expand=expand) & valid[:, None, :]
        mask = inside.any(-1).float()
        assigned = _take_rows(gt_boxes, _first_true(inside))
        zero = torch.zeros_like(assigned[..., 4])
        ctr = assigned[..., 0:3] - torch.stack([zero, assigned[..., 4] / 2.0, zero], dim=-1)
    return mask, ctr - vote_base
