"""Box IoU (counterpart of `ssd3d/core/iou.py`)."""

from __future__ import annotations

import torch


def aabb_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """IoU matrix of axis-aligned rectangles [..., k, 4] x [..., l, 4]
    (x1, z1, x2, z2) -> [..., k, l]."""
    x1 = torch.maximum(boxes_a[..., :, None, 0], boxes_b[..., None, :, 0])
    z1 = torch.maximum(boxes_a[..., :, None, 1], boxes_b[..., None, :, 1])
    x2 = torch.minimum(boxes_a[..., :, None, 2], boxes_b[..., None, :, 2])
    z2 = torch.minimum(boxes_a[..., :, None, 3], boxes_b[..., None, :, 3])
    inter = (x2 - x1).clamp(min=0.0) * (z2 - z1).clamp(min=0.0)
    area_a = (boxes_a[..., 2] - boxes_a[..., 0]) * (boxes_a[..., 3] - boxes_a[..., 1])
    area_b = (boxes_b[..., 2] - boxes_b[..., 0]) * (boxes_b[..., 3] - boxes_b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp(min=1e-8)
