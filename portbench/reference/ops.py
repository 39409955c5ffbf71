"""Plain PyTorch point, box and NMS operations of the reference.

Written after the published algorithms of 3DSSD and PointRCNN and the
reference CUDA ops' contracts (first-k ball query, three-nn, the rotated
box interior query, greedy BEV NMS). Each function's arithmetic is spelled
out step by step, so that a pick, a ball or a kept box is decided the same
way on every device. Nothing here imports the program under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TWO_PI = 2.0 * math.pi
QUERY_CHUNK = 256  # ball-query centres a chunk: bounds the [b, chunk, n] tensors
# Mean sizes (l, h, w) of KITTI's classes (3DSSD / PointRCNN model_util.py).
KITTI_MEAN_SIZES = {"Car": (3.88311640418, 1.62856739989, 1.52563191462)}


# ------------------------------------------------------------------ geometry

def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [b, n, c], idx int [b, m] -> [b, m, c]."""
    return points.gather(1, idx.long()[..., None].expand(-1, -1, points.shape[-1]))


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [b, n, c], idx int [b, m, k] -> [b, m, k, c]."""
    b, m, k = idx.shape
    return gather_points(points, idx.reshape(b, m * k)).reshape(b, m, k, -1)


def rotate_points_y(points: torch.Tensor, ry: torch.Tensor) -> torch.Tensor:
    """Rotation about y with rows (c, 0, s), (0, 1, 0), (-s, 0, c)."""
    c, s = torch.cos(ry)[..., None], torch.sin(ry)[..., None]
    x, y, z = points.unbind(-1)
    return torch.stack([c * x + s * z, y, -s * x + c * z], dim=-1)


def boxes_bottom_to_center(boxes: torch.Tensor) -> torch.Tensor:
    """(x, y, z) from the bottom face's centre to the volume's (y - h / 2)."""
    ctr_y = boxes[..., 1] - boxes[..., 4] / 2.0
    return torch.cat([boxes[..., 0:1], ctr_y[..., None], boxes[..., 2:]], dim=-1)


def boxes_to_bev_aabb(boxes: torch.Tensor) -> torch.Tensor:
    """box [..., 7] -> the axis-aligned rectangle (x1, z1, x2, z2) around its
    rotated footprint."""
    x, z = boxes[..., 0], boxes[..., 2]
    l, w, ry = boxes[..., 3], boxes[..., 5], boxes[..., 6]
    cos_r, sin_r = torch.cos(ry).abs(), torch.sin(ry).abs()
    half_dx = (l * cos_r + w * sin_r) / 2.0
    half_dz = (w * cos_r + l * sin_r) / 2.0
    return torch.stack([x - half_dx, z - half_dz, x + half_dx, z + half_dz], dim=-1)


def aabb_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of rectangles [..., k, 4] x [..., l, 4] -> [..., k, l]."""
    x1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    z1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    x2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    z2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = (x2 - x1).clamp(min=0.0) * (z2 - z1).clamp(min=0.0)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp(min=1e-8)


# ------------------------------------------------------------------ sampling

def pick_shortfall(points: torch.Tensor, picks: torch.Tensor) -> torch.Tensor:
    """How far each pick of a farthest-point sequence falls short of the
    farthest distance at its step: points [b, n, c], picks int [b, m] ->
    float64 [b, m] of (farthest - picked) / farthest, with the running
    minimum of squared distances kept in float64 from exact differences.
    Pick 0 must be point 0, and reads 1.0 where it is not. A correct sampler
    in float32 reads at most a few float32 roundings at a near-tie."""
    p = points.double()
    idx = picks.long()
    b, n, c = p.shape
    out = torch.zeros(idx.shape, dtype=torch.float64, device=p.device)
    out[:, 0] = (idx[:, 0] != 0).double()
    min_d = torch.full((b, n), float("inf"), dtype=torch.float64, device=p.device)
    for i in range(1, idx.shape[1]):
        last = p.gather(1, idx[:, i - 1, None, None].expand(b, 1, c))
        min_d = torch.minimum(min_d, ((p - last) ** 2).sum(-1))
        best = min_d.amax(1)
        got = min_d.gather(1, idx[:, i:i + 1])[:, 0]
        out[:, i] = (best - got) / best.clamp(min=1e-30)
    return out


def farthest_points(points: torch.Tensor, npoint: int) -> torch.Tensor:
    """Farthest-point sampling over vectors [b, n, c] (xyz for D-FPS, xyz
    and features for F-FPS), starting from point 0, ties to the lowest
    index -> int32 [b, npoint]. Used by the control, which picks its own."""
    b, n, c = points.shape
    out = torch.zeros(b, npoint, dtype=torch.int64, device=points.device)
    min_d = torch.full((b, n), float("inf"), dtype=torch.float32, device=points.device)
    last = torch.zeros(b, 1, 1, dtype=torch.int64, device=points.device)
    for i in range(1, npoint):
        pick = points.gather(1, last.expand(b, 1, c))
        min_d = torch.minimum(min_d, ((points - pick) ** 2).sum(-1))
        nxt = min_d.argmax(1)
        out[:, i] = nxt
        last = nxt[:, None, None]
    return out.to(torch.int32)


# ------------------------------------------------------------------ grouping

def ring_specs(radius_list, nsample_list, dilated: bool):
    """[(lo2, hi2, ns, annulus)] a ring; radii squared once in float32. A
    dilated ring k > 0 holds the points with r_{k-1}^2 <= d2 < r_k^2 (and the
    centre itself); every other ring d2 < r^2."""
    specs = []
    for i, (r, ns) in enumerate(zip(radius_list, nsample_list)):
        lo = radius_list[i - 1] if (dilated and i > 0) else 0.0
        specs.append((float(np.float32(lo * lo)), float(np.float32(r * r)), int(ns),
                      dilated and i > 0))
    return specs


def first_k(valid: torch.Tensor, ns: int):
    """The first ns true entries of each row, in index order, padded with
    the first hit (0 in an empty row) -> (idx int32 [..., ns], cnt)."""
    n = valid.shape[-1]
    iota = torch.arange(n, device=valid.device)
    key = torch.where(valid, iota, n + iota)
    if ns > n:
        key = torch.cat([key, key.new_full(key.shape[:-1] + (ns - n,), 2 * n)], -1)
    first = key.topk(ns, dim=-1, largest=False, sorted=True).values
    cnt = valid.sum(-1).clamp(max=ns)
    slots = torch.arange(ns, device=valid.device)
    idx = torch.where(slots < cnt[..., None], first, first[..., :1])
    idx = torch.where(cnt[..., None] > 0, idx, torch.zeros_like(idx))
    return idx.to(torch.int32), cnt.to(torch.int32)


def ball_query(specs, xyz: torch.Tensor, centres: torch.Tensor):
    """Multi-ring ball query: [(idx [b, m, ns], cnt [b, m])] a ring, the
    squared distance of a pair as (dx*dx + dy*dy) + dz*dz."""
    m = centres.shape[1]
    parts = [[] for _ in specs]
    for q0 in range(0, m, QUERY_CHUNK):
        d = centres[:, q0:q0 + QUERY_CHUNK, None, :] - xyz[:, None, :, :]
        dx, dy, dz = d.unbind(-1)
        d2 = (dx * dx + dy * dy) + dz * dz
        for k, (lo2, hi2, ns, annulus) in enumerate(specs):
            valid = (((d2 >= lo2) & (d2 < hi2)) | (d2 == 0.0)) if annulus else d2 < hi2
            parts[k].append(first_k(valid, ns))
    return [(torch.cat([p[0] for p in ring], 1), torch.cat([p[1] for p in ring], 1))
            for ring in parts]


def three_nn(xyz1: torch.Tensor, xyz2: torch.Tensor, chunk: int = 1024):
    """The three nearest of xyz2 [b, m, 3] to each of xyz1 [b, n, 3] ->
    (squared distances [b, n, 3], idx int32 [b, n, 3]), equal distances in
    index order."""
    m = xyz2.shape[1]
    iota = torch.arange(m, device=xyz2.device)
    dists, idxs = [], []
    for q0 in range(0, xyz1.shape[1], chunk):
        q = xyz1[:, q0:q0 + chunk]
        dx = q[:, :, None, 0] - xyz2[:, None, :, 0]
        dy = q[:, :, None, 1] - xyz2[:, None, :, 1]
        dz = q[:, :, None, 2] - xyz2[:, None, :, 2]
        work = (dx * dx + dy * dy) + dz * dz
        vals, ids = [], []
        for _ in range(3):
            i = work.argmin(-1)
            vals.append(work.gather(-1, i[..., None])[..., 0])
            ids.append(i)
            work = work.masked_fill(iota == i[..., None], float("inf"))
        dists.append(torch.stack(vals, -1))
        idxs.append(torch.stack(ids, -1))
    return torch.cat(dists, 1), torch.cat(idxs, 1).to(torch.int32)


def interpolate(feat2: torch.Tensor, idx: torch.Tensor, dist2: torch.Tensor) -> torch.Tensor:
    """Inverse-distance weighted sum (weights 1 / d2, normalised) of the
    three neighbours' features: feat2 [b, m, c] -> [b, n, c]."""
    inv = 1.0 / dist2.clamp(min=1e-10)
    w = inv / inv.sum(-1, keepdim=True)
    b, n, k = idx.shape
    g = gather_points(feat2, idx.reshape(b, n * k)).reshape(b, n, k, -1)
    return (g * w[..., None]).sum(2)


def points_in_boxes(xyz: torch.Tensor, boxes: torch.Tensor, expand: float = 0.0) -> torch.Tensor:
    """xyz [b, n, 3], boxes [b, m, 7] -> bool [b, m, n]: in the box's frame,
    with l, h and w grown by `expand`, |x| <= l/2, -h <= y <= expand/2,
    |z| <= w/2."""
    b, n, _ = xyz.shape
    m = boxes.shape[1]
    pts = xyz[:, None].expand(b, m, n, 3) - boxes[..., None, 0:3]
    canon = rotate_points_y(pts, -boxes[..., 6])
    l, h, w = (boxes[..., k:k + 1] + expand for k in (3, 4, 5))
    return ((canon[..., 0].abs() <= l / 2.0) & (canon[..., 2].abs() <= w / 2.0)
            & (canon[..., 1] <= expand / 2.0) & (canon[..., 1] >= -h))


# ------------------------------------------------------------------ box codec

def _bin_value(cls: torch.Tensor, res: torch.Tensor, size: int, interval: float,
               offset: float = 0.0) -> torch.Tensor:
    chosen = (torch.nn.functional.one_hot(cls, size).to(res.dtype) * res).sum(-1)
    return (cls.to(res.dtype) + chosen + offset) * interval


def decode(method: str, num_angle_cls: int, half_range: float, num_bins: int,
           centres: torch.Tensor, offset: torch.Tensor, angle_cls: torch.Tensor,
           angle_res: torch.Tensor, anchors: torch.Tensor | None) -> torch.Tensor:
    """Head outputs [b, n, reg, *] -> boxes [b, n, reg, 7]: 3DSSD's
    anchor-free distance coding, or PointRCNN's bin coding against anchors
    [b, n, reg, 7]."""
    b, n, r = offset.shape[:3]
    off = offset.reshape(b, n * r, -1)
    a_cls = angle_cls.reshape(b, n * r, num_angle_cls)
    a_res = angle_res.reshape(b, n * r, num_angle_cls)
    heading = _bin_value(a_cls.argmax(-1), a_res, num_angle_cls, TWO_PI / num_angle_cls)
    if method == "Dist-Anchor-free":
        half = off[..., 3:6]
        ctr = centres + off[..., 0:3]
        zero = torch.zeros_like(half[..., 1])
        ctr = ctr + torch.stack([zero, half[..., 1], zero], dim=-1)
        out = torch.cat([ctr, (half * 2.0).clamp(min=0.1), heading[..., None]], dim=-1)
    elif method == "Bin-Anchor":
        an = anchors.reshape(b, n * r, -1)
        nb = num_bins
        interval = half_range * 2.0 / nb
        dx = _bin_value(off[..., 0:nb].argmax(-1), off[..., nb:2 * nb], nb, interval, 0.5)
        dz = _bin_value(off[..., 2 * nb:3 * nb].argmax(-1), off[..., 3 * nb:4 * nb], nb,
                        interval, 0.5)
        rest = off[..., 4 * nb:]
        ctr = torch.stack([an[..., 0] - half_range + dx, an[..., 1] + rest[..., 0],
                           an[..., 2] - half_range + dz], dim=-1)
        size = (an[..., 3:6] + rest[..., 1:4]).clamp(min=0.1)
        out = torch.cat([ctr, size, (an[..., 6] + heading)[..., None]], dim=-1)
    else:
        raise ValueError(f"reference decode: regression method {method!r} not covered")
    return out.reshape(b, n, r, 7)


def class_anchors(cls_list, centres: torch.Tensor) -> torch.Tensor:
    """Anchors of the anchor-based coders: each class's mean size, the
    bottom face h / 2 below the point, heading 0 -> [b, n, cls, 7]."""
    sizes = torch.tensor([KITTI_MEAN_SIZES[c] for c in cls_list], dtype=torch.float32,
                         device=centres.device)
    b, n, _ = centres.shape
    sizes = sizes.expand(b, n, -1, 3)
    ctr = centres[:, :, None, :].expand(b, n, sizes.shape[2], 3)
    y = ctr[..., 1] + sizes[..., 1] / 2.0
    return torch.cat([ctr[..., 0:1], y[..., None], ctr[..., 2:3], sizes,
                      torch.zeros_like(y)[..., None]], -1)


# ------------------------------------------------------------------ NMS

def top_k_set(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The k largest of each row (ties to the lower index; -0.0 below +0.0),
    in index order -> int64 [b, k]."""
    bits = scores.float().contiguous().view(torch.int32).long()
    mag = bits & 0x7FFFFFFF
    key = torch.where(bits < 0, -mag - 1, mag)
    order = torch.argsort(key, dim=-1, descending=True, stable=True)
    return order[:, :k].sort(dim=-1).values


def nms_rows(bev: torch.Tensor, scores: torch.Tensor, max_output: int, threshold: float):
    """Greedy NMS over rows: candidates by descending score (a stable sort),
    each kept one suppressing every later one whose BEV IoU exceeds the
    threshold; the first max_output kept -> (idx int64 [r, max_output],
    valid bool)."""
    r, k = scores.shape
    order = torch.argsort(-scores, dim=-1, stable=True)
    sorted_boxes = bev.gather(1, order[..., None].expand(r, k, 4))
    suppress = (aabb_iou(sorted_boxes, sorted_boxes) > threshold)
    suppress &= torch.ones(k, k, dtype=torch.bool, device=bev.device).triu(1)
    keep = torch.ones(r, k, dtype=torch.bool, device=bev.device)
    for i in range(k):
        keep &= ~(suppress[:, i] & keep[:, i:i + 1])
    iota = torch.arange(k, device=bev.device)
    picked = order.gather(1, torch.argsort(torch.where(keep, iota, k + iota), dim=-1,
                                           stable=True))
    if max_output <= k:
        picked = picked[:, :max_output]
    else:
        picked = torch.nn.functional.pad(picked, (0, max_output - k))
    valid = torch.arange(max_output, device=bev.device) < keep.sum(-1, keepdim=True)
    return torch.where(valid, picked, torch.zeros_like(picked)), valid


def class_nms(boxes: torch.Tensor, scores: torch.Tensor, max_output: int, threshold: float):
    """Per-class NMS: boxes [b, n, reg, 7], scores [b, n, cls] -> dict of
    boxes [b, cls * max_output, 7], scores (-1 where not valid), classes,
    valid and index."""
    b, n, cls_num = scores.shape
    reg_idx = torch.arange(cls_num, device=scores.device).clamp(max=boxes.shape[2] - 1)
    box_pc = boxes.permute(0, 2, 1, 3)[:, reg_idx]
    sc_pc = scores.permute(0, 2, 1)
    idx, valid = nms_rows(boxes_to_bev_aabb(box_pc).reshape(b * cls_num, n, 4),
                          sc_pc.reshape(b * cls_num, n), max_output, threshold)
    idx = idx.reshape(b, cls_num, max_output)
    valid = valid.reshape(b, cls_num, max_output)
    kept = box_pc.gather(2, idx[..., None].expand(-1, -1, -1, 7))
    s_out = torch.where(valid, sc_pc.gather(2, idx), torch.full_like(sc_pc[..., :1], -1.0))
    cls = torch.arange(cls_num, device=scores.device)[None, :, None].expand(b, cls_num,
                                                                             max_output)
    return {"boxes": kept.reshape(b, -1, 7), "scores": s_out.reshape(b, -1),
            "classes": cls.reshape(b, -1), "valid": valid.reshape(b, -1),
            "index": idx.reshape(b, -1)}


def proposal_nms(boxes: torch.Tensor, scores: torch.Tensor, max_output: int, threshold: float,
                 pre_topk: int):
    """Class-unaware NMS of the RPN: each point's best class, the pre_topk
    best points, greedy NMS -> (boxes [b, max_output, 7], scores (0 where
    not valid), valid)."""
    b, n, _ = scores.shape
    best = scores.amax(-1)
    if boxes.shape[2] == 1:
        box = boxes[:, :, 0]
    else:
        cls = scores.argmax(-1)
        box = boxes.gather(2, cls[..., None, None].expand(b, n, 1, 7))[:, :, 0]
    if pre_topk and n > pre_topk:
        top = top_k_set(best, pre_topk)
        box = box.gather(1, top[..., None].expand(-1, -1, 7))
        best = best.gather(1, top)
    idx, valid = nms_rows(boxes_to_bev_aabb(box), best, max_output, threshold)
    out_boxes = box.gather(1, idx[..., None].expand(-1, -1, 7))
    out_scores = torch.where(valid, best.gather(1, idx), torch.zeros_like(best[:, :1]))
    return out_boxes, out_scores, valid
