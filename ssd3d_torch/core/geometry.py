"""Box geometry (counterpart of `ssd3d/core/geometry.py`).

box_3d = [x, y, z, l, h, w, ry]: (x, y, z) is the bottom-face centre in
camera coordinates (y points down), `l` lies along the box x axis, `w` along
its z axis, `h` upward (-y), `ry` is the rotation about y.
"""

from __future__ import annotations

import math

import torch


def rotate_points_y(points: torch.Tensor, ry: torch.Tensor) -> torch.Tensor:
    """Rotate point sets about y. points: [..., n, 3], ry: [...] -> [..., n, 3].

    The rotation rows are (c, 0, s), (0, 1, 0), (-s, 0, c); written out per
    coordinate in f32 (the JAX package's einsum at HIGHEST precision)."""
    c, s = torch.cos(ry)[..., None], torch.sin(ry)[..., None]
    x, y, z = points.unbind(-1)
    return torch.stack([c * x + s * z, y, -s * x + c * z], dim=-1)


def boxes_to_corners(boxes: torch.Tensor) -> torch.Tensor:
    """box_3d [..., 7] -> 8 corners [..., 8, 3]: bottom face first, then top
    (y = -h locally); x runs +l/2, +l/2, -l/2, -l/2 and z +w/2, -w/2, -w/2,
    +w/2, the reference's order."""
    ctr, l, h, w, ry = boxes[..., 0:3], boxes[..., 3], boxes[..., 4], boxes[..., 5], boxes[..., 6]
    half_l, half_w = l / 2.0, w / 2.0
    zero = torch.zeros_like(l)
    xs = torch.stack([half_l, half_l, -half_l, -half_l] * 2, dim=-1)
    ys = torch.stack([zero, zero, zero, zero, -h, -h, -h, -h], dim=-1)
    zs = torch.stack([half_w, -half_w, -half_w, half_w] * 2, dim=-1)
    local = torch.stack([xs, ys, zs], dim=-1)
    return rotate_points_y(local, ry) + ctr[..., None, :]


def canonicalize_points(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Points in each box's local frame. points: [..., n, 3]; boxes: [..., 7]
    -> [..., n, 3], translated by the bottom-face centre and rotated by -ry."""
    return rotate_points_y(points - boxes[..., None, 0:3], -boxes[..., 6])


def boxes_bottom_to_center(boxes: torch.Tensor) -> torch.Tensor:
    """box_3d [..., 7] with (x, y, z) moved from the bottom-face centre to the
    volumetric centre, y - h/2 (camera y points down)."""
    ctr_y = boxes[..., 1] - boxes[..., 4] / 2.0
    return torch.cat([boxes[..., 0:1], ctr_y[..., None], boxes[..., 2:]], dim=-1)


def points_in_boxes(points: torch.Tensor, boxes: torch.Tensor, expand: float = 0.0) -> torch.Tensor:
    """Membership of points in rotated 3D boxes. points: [..., n, 3]; boxes:
    [..., m, 7] -> bool [..., n, m]. `expand` enlarges l, h and w (the vote
    targets' EXPAND_DIMS_LENGTH)."""
    pts = points[..., None, :, :] - boxes[..., :, None, 0:3]  # [..., m, n, 3]
    canon = rotate_points_y(pts, -boxes[..., 6])
    l = boxes[..., 3] + expand
    h = boxes[..., 4] + expand
    w = boxes[..., 5] + expand
    inside_x = canon[..., 0].abs() <= (l[..., None] / 2.0)
    # local y spans [-h, 0] from the bottom face; the expansion splits evenly
    inside_y = (canon[..., 1] <= expand / 2.0) & (canon[..., 1] >= -(h[..., None]))
    inside_z = canon[..., 2].abs() <= (w[..., None] / 2.0)
    return (inside_x & inside_y & inside_z).transpose(-1, -2)


def flip_boxes_x(boxes: torch.Tensor) -> torch.Tensor:
    """Mirror boxes across the x = 0 plane (KITTI's flip augmentation):
    x -> -x, ry -> pi - ry."""
    return torch.cat([-boxes[..., 0:1], boxes[..., 1:6], math.pi - boxes[..., 6:7]], dim=-1)


def boxes_to_bev_aabb(boxes: torch.Tensor) -> torch.Tensor:
    """Axis-aligned BEV rectangle of box_3d [..., 7] -> [..., 4] =
    (x1, z1, x2, z2): the bounding rect of the rotated footprint."""
    x, z = boxes[..., 0], boxes[..., 2]
    l, w, ry = boxes[..., 3], boxes[..., 5], boxes[..., 6]
    cos_r, sin_r = torch.cos(ry).abs(), torch.sin(ry).abs()
    half_dx = (l * cos_r + w * sin_r) / 2.0
    half_dz = (w * cos_r + l * sin_r) / 2.0
    return torch.stack([x - half_dx, z - half_dz, x + half_dx, z + half_dz], dim=-1)


def centerness(base_xyz: torch.Tensor, boxes: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """FCOS-style 3D centre-ness of points in their assigned boxes.
    base_xyz: [..., n, 3]; boxes: [..., n, 7] -> [..., n] in (0, 1]: the
    cube root of the product of min/max face-distance ratios along l, h, w."""
    canon = rotate_points_y((base_xyz - boxes[..., 0:3])[..., None, :], -boxes[..., 6])[..., 0, :]
    l, h, w = boxes[..., 3], boxes[..., 4], boxes[..., 5]

    def ratio(a, b):
        return torch.minimum(a, b) / torch.maximum(a, b)

    ctr = (ratio(l / 2.0 - canon[..., 0], canon[..., 0] + l / 2.0)
           * ratio(-canon[..., 1], canon[..., 1] + h)
           * ratio(w / 2.0 - canon[..., 2], canon[..., 2] + w / 2.0))
    return ctr.clamp(min=eps).pow(1.0 / 3.0)


def square_distance(a: torch.Tensor, b: torch.Tensor, normalize: bool = False) -> torch.Tensor:
    """Pairwise squared distances in the a^2 + b^2 - 2ab form, as the JAX
    package computes them: a [..., n, c], b [..., m, c] -> f32 [..., n, m].

    The squared norms are summed in the inputs' dtype and the cross term is
    one matrix product in f32 (JAX's einsum at HIGHEST precision with an f32
    result), so that both packages order near-equal distances alike: the
    attention ball query keys on them. With normalize=True returns
    sqrt(max(d, 0)) / c (the reference's normalized variant)."""
    a_sq = (a * a).sum(-1, keepdim=True).float()  # [..., n, 1]
    b_sq = (b * b).sum(-1).float()[..., None, :]  # [..., 1, m]
    cross = torch.matmul(a.float(), b.float().transpose(-1, -2))
    d = a_sq + b_sq - 2.0 * cross
    if normalize:
        return torch.sqrt(d.clamp(min=0.0)) / a.shape[-1]
    return d
