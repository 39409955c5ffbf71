"""Synthetic KITTI-like scenes: a ground plane, clutter blobs and car shells.

The port's own copy of the scene generator of `tools/synth_kitti.py`
(`make_scene` and what it calls), so that the port's entry points and
`chip_smoke.py` make their scans without importing the JAX package. The
same numpy generator gives the same arrays as the original
(`tests/test_torch_config.py` checks it). Coordinates are KITTI's camera
frame: x right, y down, z forward; a box is (x, y, z, l, h, w, ry) with
(x, y, z) the centre of its bottom face.
"""

from __future__ import annotations

import numpy as np

GROUND_Y = 1.65  # camera frame, y down; road plane


def _frustum_xz(rng, n, z_lo=6.0, z_hi=68.0):
    """Random (x, z) inside the camera frustum with margin."""
    z = rng.uniform(z_lo, z_hi, n).astype(np.float32)
    x = rng.uniform(-0.78, 0.83, n).astype(np.float32) * z
    return x, z


def sample_cars(rng, k_max=5):
    """1..k_max non-colliding cars on the ground plane, 7 to 48 m ahead."""
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
    """Surface-biased points of one car: a lidar sees shells, not volumes.
    The front 40% (local +x, the heading) is a low hood capped at 0.45 h and
    its wall gets about twice the hits of the rear wall, so the heading is
    visible in the geometry; the shell is symmetric in local z."""
    x, y, z, l, h, w, ry = box
    u = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    # push each point to a random wall (keep the other two coords)
    axis = rng.integers(0, 3, n)
    side = np.sign(rng.uniform(-1, 1, n)).astype(np.float32)
    # front/back wall picks are biased toward the front (heading) face
    side = np.where(axis == 0,
                    np.where(rng.uniform(0, 1, n) < 0.68, 1.0, -1.0),
                    side).astype(np.float32)
    u[np.arange(n), axis] = side * 0.48
    # hood profile: in the front 40% of the box, crush height to <=0.45h
    hy = u[:, 1] + 0.5  # normalized height in [0, 1], 1 = roof
    front = u[:, 0] > 0.1
    hy = np.where(front, hy * 0.45, hy).astype(np.float32)
    px = u[:, 0] * l
    py = hy * -h  # [-h, 0] below the bottom-face y (y down)
    pz = u[:, 2] * w
    c, s = np.cos(ry), np.sin(ry)
    rx = c * px + s * pz
    rz = -s * px + c * pz
    return np.stack([rx + x, py + y, rz + z], 1).astype(np.float32)


def make_scene(rng, n_points=20000, k_max=5):
    """-> (points [n, 4] (x, y, z, intensity), boxes [k, 7]) with ground,
    clutter and cars; `rng` is a `numpy.random.Generator`."""
    boxes = sample_cars(rng, k_max)
    pts = []
    # ground plane
    n_ground = int(n_points * 0.55)
    gx, gz = _frustum_xz(rng, n_ground)
    gy = GROUND_Y + rng.normal(0, 0.03, n_ground).astype(np.float32)
    pts.append(np.stack([gx, gy, gz], 1))
    # clutter blobs (poles, bushes, walls)
    n_blobs = int(rng.integers(6, 14))
    for _ in range(n_blobs):
        bx, bz = _frustum_xz(rng, 1, 7.0, 60.0)
        m = int(rng.integers(40, 260))
        cx = bx[0] + rng.normal(0, 0.5, m)
        cz = bz[0] + rng.normal(0, 0.5, m)
        cy = GROUND_Y - rng.uniform(0.0, rng.uniform(0.5, 2.2), m)
        pts.append(np.stack([cx, cy, cz], 1).astype(np.float32))
    # car shells, density falling with distance
    for b in boxes:
        m = int(np.clip(9000.0 / max(b[2], 1.0), 40, 420))
        pts.append(car_points(rng, b, m))
    xyz = np.concatenate(pts).astype(np.float32)
    # top up to n_points with more ground
    if len(xyz) < n_points:
        extra = n_points - len(xyz)
        ex, ez = _frustum_xz(rng, extra)
        ey = GROUND_Y + rng.normal(0, 0.03, extra).astype(np.float32)
        xyz = np.concatenate([xyz, np.stack([ex, ey, ez], 1)])
    intensity = rng.uniform(0, 1, (len(xyz), 1)).astype(np.float32)
    return np.concatenate([xyz, intensity], 1), boxes
