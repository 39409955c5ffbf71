"""Box geometry (counterpart of `ssd3d/core/geometry.py`)."""

from __future__ import annotations

import torch


def boxes_to_bev_aabb(boxes: torch.Tensor) -> torch.Tensor:
    """Axis-aligned BEV rectangle of box_3d [..., 7] -> [..., 4] =
    (x1, z1, x2, z2): the bounding rect of the rotated footprint."""
    x, z = boxes[..., 0], boxes[..., 2]
    l, w, ry = boxes[..., 3], boxes[..., 5], boxes[..., 6]
    cos_r, sin_r = torch.cos(ry).abs(), torch.sin(ry).abs()
    half_dx = (l * cos_r + w * sin_r) / 2.0
    half_dz = (w * cos_r + l * sin_r) / 2.0
    return torch.stack([x - half_dx, z - half_dz, x + half_dx, z + half_dz], dim=-1)
