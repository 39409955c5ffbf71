"""Box IoU (counterpart of `ssd3d/core/iou.py`).

`boxes_iou_bev_3d` is the rotated BEV / 3D IoU between two box sets: the
overlap of two rotated rectangles is a fixed-shape Sutherland–Hodgman clip
of one convex quad by the other's four edges, over [pairs, 16]-padded vertex
buffers (a quad clipped by 4 half-planes has at most 8 vertices), with the
JAX package's arithmetic step for step. The BEV plane is (x, z); a box is
[x, y, z, l, h, w, ry] with y its bottom face (camera frame, y down), so 3D
IoU multiplies the BEV overlap by the overlap of [y - h, y].
"""

from __future__ import annotations

import torch

_MAX_VERTS = 16  # quad clipped by 4 half-planes has <= 8 verts; 16 is safe padding


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


def _box_bev_corners(boxes: torch.Tensor) -> torch.Tensor:
    """BEV footprint corners, counter-clockwise in the (x, z) plane:
    [..., 7] -> [..., 4, 2]."""
    x, z = boxes[..., 0], boxes[..., 2]
    half_l, half_w = boxes[..., 3] / 2.0, boxes[..., 5] / 2.0
    ry = boxes[..., 6]
    lx = torch.stack([half_l, -half_l, -half_l, half_l], dim=-1)
    lz = torch.stack([half_w, half_w, -half_w, -half_w], dim=-1)
    c, s = torch.cos(ry)[..., None], torch.sin(ry)[..., None]
    # camera-frame y-rotation acting on (x, z): x' = c*x + s*z ; z' = -s*x + c*z
    gx = c * lx + s * lz + x[..., None]
    gz = -s * lx + c * lz + z[..., None]
    return torch.stack([gx, gz], dim=-1)


def _next_index(valid: torch.Tensor) -> torch.Tensor:
    """[p, v] -> the index of each vertex's successor on its padded polygon
    (the first vertex after the last valid one)."""
    n = valid.sum(-1, keepdim=True).clamp(min=1)
    idx = torch.arange(valid.shape[-1], device=valid.device)
    return torch.where(idx + 1 < n, idx + 1, 0)


def _polygon_area(verts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Shoelace areas of padded polygons: verts [p, v, 2], valid [p, v]."""
    nxt = _next_index(valid)
    x, z = verts[..., 0], verts[..., 1]
    cross = x * z.gather(1, nxt) - x.gather(1, nxt) * z
    return torch.where(valid, cross, 0.0).sum(-1).abs() / 2.0


def _clip_by_edge(verts: torch.Tensor, valid: torch.Tensor, p0: torch.Tensor,
                  p1: torch.Tensor):
    """Clip padded polygons [p, v, 2] by the half-plane left of the directed
    edge p0 -> p1 ([p, 2] each). Each vertex emits itself if inside and the
    crossing of its segment to the next vertex if the segment crosses; the
    emitted vertices are compacted to a prefix in emission order."""
    p, v = valid.shape
    n = valid.sum(-1, keepdim=True).clamp(min=1)
    idx = torch.arange(v, device=verts.device)
    nxt = _next_index(valid)
    edge = p1 - p0
    rel = verts - p0[:, None, :]
    # signed side: positive = inside (left of edge for CCW clip polygon)
    side = edge[:, None, 0] * rel[..., 1] - edge[:, None, 1] * rel[..., 0]
    inside = (side >= 0.0) & valid
    next_side = side.gather(1, nxt)
    next_inside = inside.gather(1, nxt)
    denom = side - next_side
    t = side / torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
    nxt_verts = verts.gather(1, nxt[..., None].expand(p, v, 2))
    inter = verts + t[..., None] * (nxt_verts - verts)
    seg_valid = valid & (idx < n)
    emit_self = inside & seg_valid
    emit_inter = seg_valid & (inside ^ next_inside)
    # slot 2i holds vertex i, slot 2i+1 its crossing point
    out_pts = torch.stack([verts, inter], dim=2).reshape(p, 2 * v, 2)
    out_msk = torch.stack([emit_self, emit_inter], dim=2).reshape(p, 2 * v)
    rank = torch.cumsum(out_msk.long(), dim=1) - 1
    write_at = torch.where(out_msk & (rank < v), rank, v)  # slot v: dropped
    comp = verts.new_zeros(p, v + 1, 2)
    comp.scatter_(1, write_at[..., None].expand(p, 2 * v, 2), out_pts)
    comp_msk = torch.zeros(p, v + 1, dtype=torch.bool, device=verts.device)
    comp_msk.scatter_(1, write_at, out_msk)
    return comp[:, :v], comp_msk[:, :v]


def _pair_bev_overlap(corners_a: torch.Tensor, corners_b: torch.Tensor) -> torch.Tensor:
    """Intersection areas of convex quads, pair by pair: [p, 4, 2] each, CCW."""
    p = corners_a.shape[0]
    verts = corners_a.new_zeros(p, _MAX_VERTS, 2)
    verts[:, :4] = corners_a
    valid = torch.zeros(p, _MAX_VERTS, dtype=torch.bool, device=corners_a.device)
    valid[:, :4] = True
    for k in range(4):
        verts, valid = _clip_by_edge(verts, valid, corners_b[:, k], corners_b[:, (k + 1) % 4])
    return _polygon_area(verts, valid)


def boxes_iou_bev_3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor):
    """Full IoU matrices between two box sets: boxes_a [n, 7], boxes_b
    [m, 7] -> (iou_bev [n, m], iou_3d [n, m]). Parity target: the
    reference's calc_iou (evaluate.cpp:1161)."""
    n, m = boxes_a.shape[0], boxes_b.shape[0]
    ca = _box_bev_corners(boxes_a)  # [n, 4, 2]
    cb = _box_bev_corners(boxes_b)  # [m, 4, 2]
    overlap = _pair_bev_overlap(ca[:, None].expand(n, m, 4, 2).reshape(n * m, 4, 2),
                                cb[None].expand(n, m, 4, 2).reshape(n * m, 4, 2)).reshape(n, m)
    area_a = (boxes_a[:, 3] * boxes_a[:, 5])[:, None]
    area_b = (boxes_b[:, 3] * boxes_b[:, 5])[None, :]
    iou_bev = overlap / (area_a + area_b - overlap).clamp(min=1e-8)
    # y extent: box spans [y - h, y] (camera y down, y = bottom face)
    ymax_a, ymin_a = boxes_a[:, 1], boxes_a[:, 1] - boxes_a[:, 4]
    ymax_b, ymin_b = boxes_b[:, 1], boxes_b[:, 1] - boxes_b[:, 4]
    y_over = (torch.minimum(ymax_a[:, None], ymax_b[None, :])
              - torch.maximum(ymin_a[:, None], ymin_b[None, :])).clamp(min=0.0)
    inter_3d = overlap * y_over
    vol_a = area_a * boxes_a[:, 4][:, None]
    vol_b = area_b * boxes_b[:, 4][None, :]
    iou_3d = inter_3d / (vol_a + vol_b - inter_3d).clamp(min=1e-8)
    return iou_bev, iou_3d
