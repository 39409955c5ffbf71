"""Target assignment (counterpart of `ssd3d/train/assigner.py`), Mask method.

Shapes (GT boxes are zero-padded to a fixed count per batch):
    points      [bs, pts, 3]
    anchors     [bs, pts, cls, 7]  (anchor-free: [bs, pts, 1, 3], the points)
    gt_boxes    [bs, gt, 7]        zero rows = padding
    gt_labels   [bs, gt]           1-based; 0 = padding

Assignment takes no gradient: its outputs are masks, indices and GT boxes.
"""

from __future__ import annotations

import dataclasses

import torch

from ssd3d_torch.core.geometry import points_in_boxes


@dataclasses.dataclass(frozen=True)
class AssignerConfig:
    """The Mask method's settings; IoU assignment and minibatch subsampling,
    and the settings only they read, come with PointRCNN."""

    method: str  # 'Mask' | 'IoU'
    minibatch_size: int  # -1: use every point
    effective_sample_range: float  # CLASSIFICATION_LOSS.SOFTMAX_SAMPLE_RANGE

    @classmethod
    def from_cfg(cls, stage_cfg):
        return cls(
            method=stage_cfg.ASSIGN_METHOD,
            minibatch_size=stage_cfg.MINIBATCH_NUM,
            effective_sample_range=stage_cfg.CLASSIFICATION_LOSS.SOFTMAX_SAMPLE_RANGE,
        )


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first true entry along the last axis (0 when none): the
    first maximum, as jnp.argmax returns it. argmax takes no bool."""
    return mask.to(torch.uint8).argmax(-1)


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [bs, g, ...], idx [bs, pts] -> [bs, pts, ...]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


@torch.no_grad()
def assign_targets(cfg: AssignerConfig, points: torch.Tensor, anchors: torch.Tensor,
                   gt_boxes: torch.Tensor, gt_labels: torch.Tensor) -> dict:
    """Per-point, per-class targets (TargetAssigner.assign semantics): a point
    inside a GT box is positive for the box's class if it lies within
    `effective_sample_range` of the box's centre; a point in no box is
    negative."""
    if cfg.method != "Mask":
        raise NotImplementedError(
            f"assign_targets: {cfg.method!r} assignment needs the 3D IoU ops, "
            f"which come with PointRCNN (ROADMAP Queue 1 item 10)")
    if cfg.minibatch_size != -1:
        raise NotImplementedError(
            "assign_targets: minibatch subsampling (MINIBATCH_NUM != -1) comes "
            "with PointRCNN (ROADMAP Queue 1 item 10)")
    bs, pts_num, cls_num = anchors.shape[:3]
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
    fg = inside.any(-1)  # [bs, pts]
    pmask = (fg[..., None] & dist_ok).float() * label_mask
    nmask = (~fg)[..., None].expand(bs, pts_num, cls_num).float() * label_mask
    # positive points keep their class id, negatives get 0
    gt_cls = (labels[..., None] * pmask.to(labels.dtype)).sum(-1)
    return {
        "assigned_idx": assigned_idx,
        "pmask": pmask,
        "nmask": nmask,
        "gt_cls": gt_cls.to(torch.int32),
        "gt_boxes": assigned_boxes[:, :, None, :].expand(bs, pts_num, cls_num, 7),
    }


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
