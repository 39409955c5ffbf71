"""Training-time point-cloud augmentation (host-side numpy, deterministic).

The port's copy of `ssd3d/data/augment.py` (numpy only;
tests/test_torch_data.py holds the two to the same outputs).

Behavioral parity with the reference pipeline
(builder/data_augmentor.py:46-100 + utils/voxelnet_aug.py), in order:
    1. GT-sampling "mixup": paste database objects into the scene if their
       (enlarged) BEV footprint doesn't collide; snap pasted boxes onto the
       road plane (voxelnet_aug.py:197-249).
    2. random x-flip of points + boxes (kitti_aug.py).
    3. per-object noise: per-GT rotation/translation(/scale) with 100-try
       BEV collision rejection (voxelnet_aug.py:9-100, 403-440).
    4. global rotation about y; 5. global scale.
    6. drop GT boxes with no interior points (filter_points_boxes_3d).

All randomness flows through an explicit np.random.Generator so worker
pipelines are reproducible.
"""

from __future__ import annotations

import numpy as np

Array = np.ndarray


# ---------------------------------------------------------------------------
# BEV geometry (numpy twins of core.geometry for the host pipeline)
# ---------------------------------------------------------------------------

def bev_corners(boxes: Array, enlarge: Array | float = 0.0) -> Array:
    """BEV footprint corners in the (x, z) plane. boxes: [n, 7] -> [n, 4, 2]."""
    x, z = boxes[:, 0], boxes[:, 2]
    l = boxes[:, 3] + (enlarge[0] if np.ndim(enlarge) else enlarge)
    w = boxes[:, 5] + (enlarge[2] if np.ndim(enlarge) else enlarge)
    ry = boxes[:, 6]
    lx = np.stack([l, -l, -l, l], 1) / 2.0
    lz = np.stack([w, w, -w, -w], 1) / 2.0
    c, s = np.cos(ry)[:, None], np.sin(ry)[:, None]
    return np.stack(
        [c * lx + s * lz + x[:, None], -s * lx + c * lz + z[:, None]], axis=-1
    )


def _segments_cross(a0, a1, b0, b1):
    """Proper intersection of segment sets: a*: [n,2], b*: [m,2] -> [n,m]."""
    def side(p, q, r):  # sign of cross(q-p, r-p): r relative to line p->q
        return (
            (q[..., 0] - p[..., 0]) * (r[..., 1] - p[..., 1])
            - (q[..., 1] - p[..., 1]) * (r[..., 0] - p[..., 0])
        )

    a0 = a0[:, None]
    a1 = a1[:, None]
    b0 = b0[None, :]
    b1 = b1[None, :]
    d1 = side(a0, a1, b0) * side(a0, a1, b1)
    d2 = side(b0, b1, a0) * side(b0, b1, a1)
    return (d1 < 0) & (d2 < 0)


def _point_in_quad(pts: Array, quad: Array) -> Array:
    """pts: [n, 2]; quad: [4, 2] (CCW) -> [n] bool (strict interior)."""
    inside = np.ones(len(pts), bool)
    for k in range(4):
        e = quad[(k + 1) % 4] - quad[k]
        rel = pts - quad[k]
        inside &= (e[0] * rel[:, 1] - e[1] * rel[:, 0]) > 0
    return inside


def bev_collision(corners_a: Array, corners_b: Array) -> Array:
    """Convex-quad overlap matrix [n, m]: any edge crossing or containment
    (same outcome as the reference's box_collision_test)."""
    n, m = len(corners_a), len(corners_b)
    out = np.zeros((n, m), bool)
    if n == 0 or m == 0:
        return out
    for k in range(4):
        for j in range(4):
            out |= _segments_cross(
                corners_a[:, k], corners_a[:, (k + 1) % 4],
                corners_b[:, j], corners_b[:, (j + 1) % 4],
            )
    # containment (no edge crossings): test one vertex each way
    for i in range(n):
        rem = ~out[i]
        if rem.any():
            idx = np.where(rem)[0]
            inside_a = np.array(
                [_point_in_quad(corners_b[j, :1], corners_a[i]).item() for j in idx]
            )
            inside_b = np.array(
                [_point_in_quad(corners_a[i, :1], corners_b[j]).item() for j in idx]
            )
            out[i, idx] |= inside_a | inside_b
    return out


def points_in_boxes_np(points: Array, boxes: Array, expand: float = 0.0) -> Array:
    """points: [n, >=3]; boxes: [m, 7] -> bool [n, m] (numpy twin of
    core.geometry.points_in_boxes / reference check_inside_points)."""
    if len(boxes) == 0:
        return np.zeros((len(points), 0), bool)
    rel = points[None, :, 0:3] - boxes[:, None, 0:3]
    c, s = np.cos(boxes[:, 6])[:, None], np.sin(boxes[:, 6])[:, None]
    cx = c * rel[..., 0] - s * rel[..., 2]
    cz = s * rel[..., 0] + c * rel[..., 2]
    cy = rel[..., 1]
    l = boxes[:, 3:4] + expand
    h = boxes[:, 4:5] + expand
    w = boxes[:, 5:6] + expand
    inside = (
        (np.abs(cx) <= l / 2)
        & (np.abs(cz) <= w / 2)
        & (cy <= expand / 2)
        & (cy >= -h)
    )
    return inside.T


# ---------------------------------------------------------------------------
# augmentation stages
# ---------------------------------------------------------------------------

def mixup_place(
    rng: np.random.Generator,
    sampled_boxes: Array,  # [k, 7] database boxes
    sampled_classes: Array,  # [k] int
    sampled_points: list,  # k arrays of interior points [*, 4]
    boxes: Array,
    classes: Array,
    points: Array,
    sem_labels: Array,
    sem_dists: Array,
    plane: Array,
    enlarge_range=(0.5, 2.0, 0.5),
):
    """Greedy non-colliding paste with road-plane snapping
    (voxelnet_aug.py:197-249 box_3d_collision_test)."""
    a, b, c, d = plane
    cand_corners = bev_corners(sampled_boxes, np.asarray(enlarge_range))
    for i in range(len(sampled_boxes)):
        scene_corners = bev_corners(boxes)
        if bev_collision(cand_corners[i: i + 1], scene_corners).any():
            continue
        box = sampled_boxes[i].copy()
        pts = sampled_points[i].copy()
        # snap the box bottom onto the road plane
        plane_y = (-d - a * box[0] - c * box[2]) / b
        dy = box[1] - plane_y
        pts[:, 1] -= dy
        box[1] -= dy
        points = np.concatenate([points, pts], axis=0)
        sem_labels = np.concatenate(
            [sem_labels, np.full(len(pts), sampled_classes[i], sem_labels.dtype)]
        )
        sem_dists = np.concatenate(
            [sem_dists, np.ones(len(pts), sem_dists.dtype)]
        )
        boxes = np.concatenate([boxes, box[None]], axis=0)
        classes = np.concatenate([classes, [sampled_classes[i]]], axis=0)
    return boxes, classes, points, sem_labels, sem_dists


def flip_x(points: Array, boxes: Array):
    """Mirror scene across x=0 (kitti_aug.py:14/:48)."""
    points = points.copy()
    points[:, 0] = -points[:, 0]
    boxes = boxes.copy()
    boxes[:, 0] = -boxes[:, 0]
    boxes[:, 6] = np.where(
        boxes[:, 6] >= 0, np.pi - boxes[:, 6], -np.pi - boxes[:, 6]
    )
    return points, boxes


def per_object_noise(
    rng: np.random.Generator,
    boxes: Array,
    points: Array,
    sem_labels: Array,
    rotation_perturb=(-np.pi / 3, np.pi / 3),
    center_noise_std=(1.0, 1.0, 0.0),  # (x, z, y) stds, reference order
    scale_range=(1.0, 1.0),
    expand: float = 0.1,
    num_try: int = 100,
):
    """Independent per-GT jitter with BEV collision rejection
    (voxelnet_aug.py:9-100 noise_per_object_v3_ + :403 noise_per_box).

    Returns (boxes, points) — foreground points move with their first
    containing box; transform order: center -> scale -> rotate -> +loc.
    """
    n = len(boxes)
    if n == 0:
        return boxes, points
    std = np.asarray(center_noise_std, np.float64)
    # noise in (x, z, y): std order follows the reference's rearranged axes
    loc_noise = rng.normal(scale=std, size=(n, num_try, 3))
    rot_noise = rng.uniform(rotation_perturb[0], rotation_perturb[1], (n, num_try))
    scale_noise = rng.uniform(scale_range[0], scale_range[1], (n, num_try))

    corners = bev_corners(boxes, expand)  # collision geometry uses the
    # expanded footprint, matching gt_boxes_expand in the reference
    chosen = np.full(n, -1, np.int64)
    for i in range(n):
        ctr = boxes[i, [0, 2]]
        for j in range(num_try):
            cur = (corners[i] - ctr) * scale_noise[i, j]
            ang = rot_noise[i, j]
            c_, s_ = np.cos(ang), np.sin(ang)
            cur = cur @ np.array([[c_, -s_], [s_, c_]])
            cur = cur + ctr + loc_noise[i, j, 0:2]
            coll = bev_collision(cur[None], corners)
            coll[0, i] = False
            if not coll.any():
                chosen[i] = j
                corners[i] = cur
                break

    # apply to foreground points (first containing box wins)
    inside = points_in_boxes_np(points, boxes, expand=expand)  # [pts, n]
    inside &= sem_labels[:, None] > 0
    any_in = inside.any(axis=1)
    first_box = np.argmax(inside, axis=1)
    new_points = points.copy()
    new_boxes = boxes.copy()
    for i in range(n):
        j = chosen[i]
        if j < 0:
            continue
        sel = np.where(any_in & (first_box == i))[0]
        ang, sc = rot_noise[i, j], scale_noise[i, j]
        loc = np.array(
            [loc_noise[i, j, 0], loc_noise[i, j, 2], loc_noise[i, j, 1]]
        )  # back to (x, y, z)
        if len(sel):
            rel = new_points[sel, 0:3] - boxes[i, 0:3]
            rel *= sc
            c_, s_ = np.cos(ang), np.sin(ang)
            # BEV rotation in (x, z); y unchanged
            rx = rel[:, 0] * c_ + rel[:, 2] * s_
            rz = -rel[:, 0] * s_ + rel[:, 2] * c_
            rel = np.stack([rx, rel[:, 1], rz], 1)
            new_points[sel, 0:3] = rel + boxes[i, 0:3] + loc
        new_boxes[i, 0:3] += loc
        new_boxes[i, 3:6] *= sc
        new_boxes[i, 6] += ang
    return new_boxes, new_points


def global_rotation(rng: np.random.Generator, points, boxes, rotation_range):
    angle = (rng.random() * 2 - 1) * rotation_range
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], points.dtype)
    points = points.copy()
    boxes = boxes.copy()
    points[:, 0:3] = points[:, 0:3] @ rot.T
    boxes[:, 0:3] = boxes[:, 0:3] @ rot.T
    boxes[:, 6] += angle
    return points, boxes


def global_scale(rng: np.random.Generator, points, boxes, scale_range):
    scale = (rng.random() * 2 - 1) * scale_range + 1.0
    points = points.copy()
    boxes = boxes.copy()
    points[:, 0:3] *= scale
    boxes[:, 0:6] *= scale
    return points, boxes


def filter_stray_points(boxes, points, sem_labels, sem_dists,
                        enlarge_range=(0.5, 2.0, 0.5)):
    """Drop sem-negative points that fall inside any ENLARGED GT box; keep
    every sem-positive point. Augmentation moves boxes, so background points
    can end up inside an object footprint — the reference removes them so
    the interior of each (enlarged) box holds only that object's points.
    Boxes are never dropped. Point order matches the reference exactly
    (positives first, then surviving negatives) because the subsequent
    random point sampling consumes this order
    (reference: lib/utils/voxelnet_aug.py:345 filter_points_boxes_3d,
    called from lib/builder/data_augmentor.py:99)."""
    if len(boxes) == 0:
        return boxes, points, sem_labels, sem_dists
    enlarged = boxes.copy()
    enlarged[:, 3:6] += np.asarray(enlarge_range, boxes.dtype)
    pos_index = np.where(sem_labels >= 1)[0]
    neg_index = np.where(sem_labels == 0)[0]
    inside = points_in_boxes_np(points[neg_index], enlarged)  # [n_neg, gt]
    neg_kept = neg_index[~inside.any(axis=1)]
    order = np.concatenate([pos_index, neg_kept])
    return boxes, points[order], sem_labels[order], sem_dists[order]


class Augmentor:
    """Config-driven augmentation chain (builder/data_augmentor.py)."""

    def __init__(self, cfg, mixup_db=None):
        aug = cfg.TRAIN.AUGMENTATIONS
        self.enabled = aug.OPEN
        self.flip = aug.FLIP
        self.probs = list(aug.PROB)
        self.rotation_range = aug.RANDOM_ROTATION_RANGE
        self.scale_range = aug.RANDOM_SCALE_RANGE
        self.single = aug.SINGLE_AUG
        self.expand = aug.EXPAND_DIMS_LENGTH
        self.mixup_db = mixup_db if aug.MIXUP.OPEN else None

    def __call__(self, rng, points, sem_labels, sem_dists, boxes, classes,
                 plane):
        if not self.enabled:
            return points, sem_labels, sem_dists, boxes, classes
        if self.mixup_db is not None:
            s_boxes, s_classes, s_points = self.mixup_db.sample(rng)
            boxes, classes, points, sem_labels, sem_dists = mixup_place(
                rng, s_boxes, s_classes, s_points, boxes, classes, points,
                sem_labels, sem_dists, plane,
            )
        if self.flip and rng.random() >= 0.5:
            points, boxes = flip_x(points, boxes)

        choice = rng.random(3)
        if choice[0] <= self.probs[0]:
            boxes, points = per_object_noise(
                rng, boxes, points, sem_labels,
                rotation_perturb=tuple(self.single.ROTATION_PERTURB),
                center_noise_std=tuple(self.single.CENTER_NOISE_STD),
                scale_range=tuple(self.single.RANDOM_SCALE_RANGE),
                expand=self.expand,
            )
        if choice[1] <= self.probs[1]:
            points, boxes = global_rotation(rng, points, boxes, self.rotation_range)
        if choice[2] <= self.probs[2]:
            points, boxes = global_scale(rng, points, boxes, self.scale_range)

        boxes, points, sem_labels, sem_dists = filter_stray_points(
            boxes, points, sem_labels, sem_dists
        )
        return points, sem_labels, sem_dists, boxes, classes
