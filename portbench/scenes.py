"""Synthetic KITTI-like LiDAR scans: a road plane, clutter blobs (poles,
bushes, walls) and car shells whose density falls with distance, in
KITTI's camera frame (x right, y down, z forward); a box is (x, y, z, l,
h, w, ry) with (x, y, z) its bottom face's centre.

The benchmark's own copy of the program's synthetic scene generator, so
that the traffic stays fixed whatever later changes make of the program's.
"""

from __future__ import annotations

import numpy as np

GROUND_Y = 1.65  # the road plane, camera frame


def _frustum_xz(rng, n, z_lo=6.0, z_hi=68.0):
    z = rng.uniform(z_lo, z_hi, n).astype(np.float32)
    x = rng.uniform(-0.78, 0.83, n).astype(np.float32) * z
    return x, z


def sample_cars(rng, k_max=5):
    """1..k_max cars on the road, 7 to 48 m ahead, at least 6 m apart."""
    k = int(rng.integers(1, k_max + 1))
    boxes = []
    for _ in range(50):
        if len(boxes) == k:
            break
        z = float(rng.uniform(7.0, 48.0))
        x = float(rng.uniform(-0.6, 0.65)) * z * 0.8
        l, h, w = (np.array([3.9, 1.56, 1.6]) * rng.uniform(0.9, 1.1, 3))
        ry = float(rng.uniform(-np.pi, np.pi))
        if all((x - b[0]) ** 2 + (z - b[2]) ** 2 > 36.0 for b in boxes):
            boxes.append([x, GROUND_Y, z, float(l), float(h), float(w), ry])
    return np.asarray(boxes, np.float32).reshape(-1, 7)


def car_points(rng, box, n):
    """Points on a car's walls; the front 40% a low hood, its wall hit twice
    as often as the rear one."""
    x, y, z, l, h, w, ry = box
    u = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    axis = rng.integers(0, 3, n)
    side = np.sign(rng.uniform(-1, 1, n)).astype(np.float32)
    side = np.where(axis == 0, np.where(rng.uniform(0, 1, n) < 0.68, 1.0, -1.0),
                    side).astype(np.float32)
    u[np.arange(n), axis] = side * 0.48
    hy = u[:, 1] + 0.5
    hy = np.where(u[:, 0] > 0.1, hy * 0.45, hy).astype(np.float32)
    px, py, pz = u[:, 0] * l, hy * -h, u[:, 2] * w
    c, s = np.cos(ry), np.sin(ry)
    return np.stack([c * px + s * pz + x, py + y, -s * px + c * pz + z], 1).astype(np.float32)


def make_scene(rng, n_points=20000, k_max=5):
    """-> (points [n, 4] (x, y, z, intensity), boxes [k, 7])."""
    boxes = sample_cars(rng, k_max)
    pts = []
    n_ground = int(n_points * 0.55)
    gx, gz = _frustum_xz(rng, n_ground)
    gy = GROUND_Y + rng.normal(0, 0.03, n_ground).astype(np.float32)
    pts.append(np.stack([gx, gy, gz], 1))
    for _ in range(int(rng.integers(6, 14))):
        bx, bz = _frustum_xz(rng, 1, 7.0, 60.0)
        m = int(rng.integers(40, 260))
        cx = bx[0] + rng.normal(0, 0.5, m)
        cz = bz[0] + rng.normal(0, 0.5, m)
        cy = GROUND_Y - rng.uniform(0.0, rng.uniform(0.5, 2.2), m)
        pts.append(np.stack([cx, cy, cz], 1).astype(np.float32))
    for b in boxes:
        pts.append(car_points(rng, b, int(np.clip(9000.0 / max(b[2], 1.0), 40, 420))))
    xyz = np.concatenate(pts).astype(np.float32)
    if len(xyz) < n_points:
        extra = n_points - len(xyz)
        ex, ez = _frustum_xz(rng, extra)
        ey = GROUND_Y + rng.normal(0, 0.03, extra).astype(np.float32)
        xyz = np.concatenate([xyz, np.stack([ex, ey, ez], 1)])
    intensity = rng.uniform(0, 1, (len(xyz), 1)).astype(np.float32)
    return np.concatenate([xyz, intensity], 1), boxes


def scan_pool(seed: int, count: int, n_points: int, max_cars: int) -> dict:
    """`count` scans of exactly n_points points each (drawn without
    replacement from a scene of n_points + 2,048), with their car boxes
    zero-padded to max_cars rows -> numpy points f32 [count, n, 4],
    gt_boxes f32 [count, max_cars, 7], gt_labels int32 [count, max_cars]."""
    rng = np.random.default_rng([seed, 0x5CA7])
    points = np.zeros((count, n_points, 4), np.float32)
    gt_boxes = np.zeros((count, max_cars, 7), np.float32)
    gt_labels = np.zeros((count, max_cars), np.int32)
    for i in range(count):
        pts, boxes = make_scene(rng, n_points=n_points + 2048, k_max=max_cars)
        points[i] = pts[rng.choice(len(pts), n_points, replace=False)]
        gt_boxes[i, :len(boxes)] = boxes
        gt_labels[i, :len(boxes)] = 1
    return {"points": points, "gt_boxes": gt_boxes, "gt_labels": gt_labels}
