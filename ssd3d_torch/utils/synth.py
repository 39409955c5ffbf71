"""Synthetic KITTI-like scenes and KITTI object trees on disk.

The port's own copy of `tools/synth_kitti.py` (`make_scene`, the hard-mode
multiclass scenes and `write_tree`, with what they call), so that the
port's entry points, its tests and `chip_smoke.py` make their scans and
trees without importing the JAX package. The same numpy generator gives
the same arrays and the same files as the original
(`tests/test_torch_config.py` checks it). Coordinates are KITTI's camera
frame: x right, y down, z forward; a box is (x, y, z, l, h, w, ry) with
(x, y, z) the centre of its bottom face. `write_tree` lays a tree out as
KITTI's object split is: velodyne/*.bin, calib/*.txt, label_2/*.txt,
planes/*.txt, image_2/*.png and the train/val (and test) list files.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from ssd3d_torch.data.kitti_io import Calibration

# a real-ish KITTI calibration (P2 with small offsets, R0 near identity,
# velo->cam axis permutation), as tools/synth_kitti.py writes it
CALIB_TXT = """P0: 700 0 600 0 0 700 180 0 0 0 1 0
P1: 700 0 600 0 0 700 180 0 0 0 1 0
P2: 700 0 600 44.8 0 700 180 0.1 0 0 1 0.003
P3: 700 0 600 0 0 700 180 0 0 0 1 0
R0_rect: 0.9999 0.0098 -0.0074 -0.0099 0.9999 -0.0043 0.0074 0.0043 0.9999
Tr_velo_to_cam: 0.0076 -0.9999 -0.0006 -0.0027 -0.0022 0.0006 -0.9999 -0.0576 0.9999 0.0076 -0.0022 -0.3321
Tr_imu_to_velo: 1 0 0 0 0 1 0 0 0 0 1 0
"""

IMG_H, IMG_W = 375, 1242
GROUND_Y = 1.65  # camera frame, y down; road plane


def write_png(path: str, h: int, w: int) -> None:
    """Minimal valid grayscale PNG (only the header size is ever read)."""

    def chunk(typ, data):
        c = typ + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    raw = zlib.compress(b"".join(b"\x00" + b"\x80" * w for _ in range(h)))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", raw))
        f.write(chunk(b"IEND", b""))


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


# ---------------------------------------------------------------------------
# hard-mode multiclass scenes: every difficulty gate of the KITTI evaluator
# (evaluate.cpp:37-40 — min 2D height 40/25/25 px, max occlusion 0/1/2, max
# truncation 0.15/0.30/0.50 for Easy/Moderate/Hard) is exercised, across
# Car / Pedestrian / Cyclist, with Van + DontCare distractors and car-like
# unlabeled clutter so the metric cannot saturate at 100.

CLASS_SPECS = {
    # dims (l, h, w) mean, point-budget numerator, sampling weight
    "Car": dict(dims=(3.9, 1.56, 1.6), pts=9000.0, weight=0.4),
    "Pedestrian": dict(dims=(0.8, 1.73, 0.6), pts=3400.0, weight=0.3),
    "Cyclist": dict(dims=(1.76, 1.73, 0.6), pts=3600.0, weight=0.3),
}
VAN_DIMS = (4.6, 2.05, 1.9)


def _occlude_points(rng, pts, ctr_xz, frac):
    """Drop `frac` of a box's points on one side of a random vertical plane
    through the box center — occluders hide one side, not random points."""
    if len(pts) == 0 or frac <= 0:
        return pts
    theta = rng.uniform(0, 2 * np.pi)
    d = (pts[:, 0] - ctr_xz[0]) * np.cos(theta) + (
        pts[:, 2] - ctr_xz[1]
    ) * np.sin(theta)
    cut = np.quantile(d, 1.0 - frac)
    keep = d <= cut
    return pts[keep]


def sample_objects(rng, k_max=8):
    """Mixed-class, non-colliding objects whose poses + occlusion labels
    span all three difficulty bins. Returns a list of dicts."""
    names = list(CLASS_SPECS)
    weights = np.array([CLASS_SPECS[n]["weight"] for n in names])
    weights = weights / weights.sum()
    k = int(rng.integers(max(3, k_max // 2), k_max + 1))
    objs = []
    for _ in range(80):
        if len(objs) >= k:
            break
        cls = names[int(rng.choice(len(names), p=weights))]
        spec = CLASS_SPECS[cls]
        # z spread biased toward the near field so the 40 px Easy gate has a
        # real pool (h=1.56 m @ f=700 -> >40 px needs z < ~27 m); the near
        # bias is 0.55 so a 48-scan val split carries >=30 Easy GT per class
        # (Easy cells otherwise quantize at one-box resolution)
        z = float(rng.uniform(7.0, 55.0) if rng.uniform() < 0.45
                  else rng.uniform(7.0, 24.0))
        # ~15% of objects hug the frustum edge -> nonzero truncation
        if rng.uniform() < 0.15:
            x = float(rng.choice([-1.0, 1.0])) * float(
                rng.uniform(0.70, 0.95)
            ) * z
        else:
            x = float(rng.uniform(-0.6, 0.65)) * z * 0.8
        dims = np.array(spec["dims"]) * rng.uniform(0.9, 1.1, 3)
        ry = float(rng.uniform(-np.pi, np.pi))
        min_gap = (dims[0] / 2 + 2.0) ** 2
        if any((x - o["box"][0]) ** 2 + (z - o["box"][2]) ** 2 < min_gap +
               (o["box"][3] / 2) ** 2 for o in objs):
            continue
        occ = int(rng.choice(3, p=[0.55, 0.27, 0.18]))
        objs.append(dict(
            cls=cls, occ=occ,
            box=np.array([x, GROUND_Y, z, dims[0], dims[1], dims[2], ry],
                         np.float32),
        ))
    return objs


def make_scene_hard(rng, n_points=20000, k_max=8):
    """-> (points_rect [n,4], objects, dontcare_2d).

    objects: list of dicts {cls, occ, box[7]} incl. 'Van' distractors;
    dontcare_2d: list of 3D boxes whose 2D projections become DontCare
    labels (their points stay in the scene unlabeled)."""
    objs = sample_objects(rng, k_max)
    # Van distractors: real vehicles the Car metric must IGNORE (neighboring
    # class, evaluate.cpp) — detections on them are neither TP nor FP
    for _ in range(int(rng.integers(0, 3))):
        z = float(rng.uniform(9.0, 45.0))
        x = float(rng.uniform(-0.55, 0.6)) * z * 0.8
        dims = np.array(VAN_DIMS) * rng.uniform(0.92, 1.08, 3)
        if any((x - o["box"][0]) ** 2 + (z - o["box"][2]) ** 2 < 40.0
               for o in objs):
            continue
        objs.append(dict(
            cls="Van", occ=int(rng.choice(3, p=[0.6, 0.25, 0.15])),
            box=np.array([x, GROUND_Y, z, dims[0], dims[1], dims[2],
                          float(rng.uniform(-np.pi, np.pi))], np.float32),
        ))

    pts = []
    n_ground = int(n_points * 0.5)
    gx, gz = _frustum_xz(rng, n_ground)
    gy = GROUND_Y + rng.normal(0, 0.03, n_ground).astype(np.float32)
    pts.append(np.stack([gx, gy, gz], 1))
    n_blobs = int(rng.integers(8, 16))
    for _ in range(n_blobs):
        bx, bz = _frustum_xz(rng, 1, 7.0, 60.0)
        m = int(rng.integers(40, 260))
        cx = bx[0] + rng.normal(0, 0.5, m)
        cz = bz[0] + rng.normal(0, 0.5, m)
        cy = GROUND_Y - rng.uniform(0.0, rng.uniform(0.5, 2.2), m)
        pts.append(np.stack([cx, cy, cz], 1).astype(np.float32))

    # unlabeled car-LIKE clutter shells (dumpsters, sheds): shrunk/stretched
    # car boxes with surface points — the precision ceiling below 100
    dontcare = []
    for _ in range(int(rng.integers(1, 4))):
        z = float(rng.uniform(8.0, 50.0))
        x = float(rng.uniform(-0.6, 0.6)) * z * 0.8
        if any((x - o["box"][0]) ** 2 + (z - o["box"][2]) ** 2 < 30.0
               for o in objs):
            continue
        scale = rng.uniform([0.55, 0.6, 0.8], [0.85, 1.5, 1.4])
        dims = np.array([3.9, 1.56, 1.6]) * scale
        fake = np.array([x, GROUND_Y, z, dims[0], dims[1], dims[2],
                         float(rng.uniform(-np.pi, np.pi))], np.float32)
        m = int(np.clip(7000.0 / max(z, 1.0), 30, 300))
        pts.append(car_points(rng, fake, m))
        # half become DontCare regions (evaluator ignores hits there), half
        # stay fully unlabeled (hits there are clean false positives)
        if rng.uniform() < 0.5:
            dontcare.append(fake)

    for o in objs:
        b = o["box"]
        m = int(np.clip(
            CLASS_SPECS.get(o["cls"], {"pts": 9000.0})["pts"] / max(b[2], 1.0),
            25, 420,
        ))
        p = car_points(rng, b, m)
        frac = {0: 0.0, 1: 0.35, 2: 0.62}[o["occ"]]
        p = _occlude_points(rng, p, (b[0], b[2]), frac)
        pts.append(p)

    xyz = np.concatenate(pts).astype(np.float32)
    xyz[:, :3] += rng.normal(0, 0.015, (len(xyz), 3)).astype(np.float32)
    if len(xyz) < n_points:
        extra = n_points - len(xyz)
        ex, ez = _frustum_xz(rng, extra)
        ey = GROUND_Y + rng.normal(0, 0.03, extra).astype(np.float32)
        xyz = np.concatenate([xyz, np.stack([ex, ey, ez], 1)])
    intensity = rng.uniform(0, 1, (len(xyz), 1)).astype(np.float32)
    return np.concatenate([xyz, intensity], 1), objs, dontcare


def truncation_of(box, P2):
    """Fraction of the 2D box area clipped away by the image bounds."""
    x1, y1, x2, y2 = project_box2d(box, P2)  # clipped
    xs1, ys1, xs2, ys2 = project_box2d_unclipped(box, P2)
    full = max(xs2 - xs1, 1e-3) * max(ys2 - ys1, 1e-3)
    vis = max(x2 - x1, 0.0) * max(y2 - y1, 0.0)
    return float(np.clip(1.0 - vis / full, 0.0, 0.98))


def project_box2d_unclipped(box, P2):
    x, y, z, l, h, w, ry = box
    xs = np.array([l / 2, l / 2, -l / 2, -l / 2] * 2)
    ys = np.array([0, 0, 0, 0, -h, -h, -h, -h])
    zs = np.array([w / 2, -w / 2, -w / 2, w / 2] * 2)
    c, s = np.cos(ry), np.sin(ry)
    cx = c * xs + s * zs + x
    cz = -s * xs + c * zs + z
    cy = ys + y
    hom = np.stack([cx, cy, cz, np.ones(8)], 1)
    uvw = hom @ P2.T
    uv = uvw[:, :2] / np.maximum(uvw[:, 2:3], 1e-6)
    return uv[:, 0].min(), uv[:, 1].min(), uv[:, 0].max(), uv[:, 1].max()


def project_box2d(box, P2):
    """3D box -> clipped 2D image box (same corner math as the framework)."""
    x, y, z, l, h, w, ry = box
    xs = np.array([l / 2, l / 2, -l / 2, -l / 2] * 2)
    ys = np.array([0, 0, 0, 0, -h, -h, -h, -h])
    zs = np.array([w / 2, -w / 2, -w / 2, w / 2] * 2)
    c, s = np.cos(ry), np.sin(ry)
    cx = c * xs + s * zs + x
    cz = -s * xs + c * zs + z
    cy = ys + y
    hom = np.stack([cx, cy, cz, np.ones(8)], 1)
    uvw = hom @ P2.T
    uv = uvw[:, :2] / np.maximum(uvw[:, 2:3], 1e-6)
    x1 = np.clip(uv[:, 0].min(), 0, IMG_W)
    x2 = np.clip(uv[:, 0].max(), 0, IMG_W)
    y1 = np.clip(uv[:, 1].min(), 0, IMG_H)
    y2 = np.clip(uv[:, 1].max(), 0, IMG_H)
    return x1, y1, x2, y2


def write_tree(root, n_train=48, n_val=16, n_points=20000, seed=0, k_max=5,
               n_test=0, hard=False):
    """Generate the full KITTI object tree + list files under `root`.

    `n_test > 0` additionally writes a label-free `testing/` split (the
    KITTI test-server layout) + test.txt, for the `--img_list test` /
    `bin.test --split test --no_gt` submission path.

    `hard=True` switches to the multiclass hard-mode scenes: Car/Ped/Cyc
    with occlusion levels + truncation spanning every E/M/H difficulty
    bin, Van + DontCare distractors, and unlabeled car-like clutter (so
    AP plateaus below 100)."""
    base = os.path.join(root, "training")
    for sub in ("velodyne", "calib", "label_2", "planes", "image_2"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    calib_path = os.path.join(base, "calib", "000000.txt")
    with open(calib_path, "w") as f:
        f.write(CALIB_TXT)
    calib = Calibration.from_file(calib_path)
    rng = np.random.default_rng(seed)
    n_total = n_train + n_val
    for i in range(n_total):
        with open(os.path.join(base, "calib", f"{i:06d}.txt"), "w") as f:
            f.write(CALIB_TXT)
        write_png(os.path.join(base, "image_2", f"{i:06d}.png"), IMG_H, IMG_W)
        with open(os.path.join(base, "planes", f"{i:06d}.txt"), "w") as f:
            f.write(f"# Plane\nWidth 4\nHeight 1\n0 -1 0 {GROUND_Y}\n")

        if hard:
            pts_rect, objs, dontcare = make_scene_hard(rng, n_points, k_max)
            lines = []
            for o in objs:
                b = o["box"]
                x1, y1, x2, y2 = project_box2d(b, calib.P)
                if x2 - x1 < 2 or y2 - y1 < 2:
                    continue  # fully outside the image: not annotated
                trunc = truncation_of(b, calib.P)
                alpha = b[6] - np.arctan2(b[0], b[2])
                lines.append(
                    f"{o['cls']} {trunc:.2f} {o['occ']} {alpha:.2f} "
                    f"{x1:.2f} {y1:.2f} {x2:.2f} {y2:.2f} "
                    f"{b[4]:.2f} {b[5]:.2f} {b[3]:.2f} "
                    f"{b[0]:.2f} {b[1]:.2f} {b[2]:.2f} {b[6]:.2f}\n"
                )
            for b in dontcare:
                x1, y1, x2, y2 = project_box2d(b, calib.P)
                if x2 - x1 < 2 or y2 - y1 < 2:
                    continue
                lines.append(
                    f"DontCare -1 -1 -10 {x1:.2f} {y1:.2f} {x2:.2f} {y2:.2f} "
                    "-1 -1 -1 -1000 -1000 -1000 -10\n"
                )
        else:
            pts_rect, boxes = make_scene(rng, n_points, k_max)
            lines = []
            for b in boxes:
                x1, y1, x2, y2 = project_box2d(b, calib.P)
                alpha = b[6] - np.arctan2(b[0], b[2])
                lines.append(
                    f"Car 0.00 0 {alpha:.2f} "
                    f"{x1:.2f} {y1:.2f} {x2:.2f} {y2:.2f} "
                    f"{b[4]:.2f} {b[5]:.2f} {b[3]:.2f} "
                    f"{b[0]:.2f} {b[1]:.2f} {b[2]:.2f} {b[6]:.2f}\n"
                )
        velo = calib.rect_to_velo(pts_rect[:, :3])
        np.concatenate([velo, pts_rect[:, 3:4]], 1).astype(np.float32).tofile(
            os.path.join(base, "velodyne", f"{i:06d}.bin")
        )
        with open(os.path.join(base, "label_2", f"{i:06d}.txt"), "w") as f:
            f.writelines(lines)
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("".join(f"{i:06d}\n" for i in range(n_train)))
    with open(os.path.join(root, "val.txt"), "w") as f:
        f.write("".join(f"{i:06d}\n" for i in range(n_train, n_total)))

    if n_test:
        test_base = os.path.join(root, "testing")
        for sub in ("velodyne", "calib", "planes", "image_2"):  # no label_2
            os.makedirs(os.path.join(test_base, sub), exist_ok=True)
        for i in range(n_test):
            with open(os.path.join(test_base, "calib", f"{i:06d}.txt"),
                      "w") as f:
                f.write(CALIB_TXT)
            write_png(os.path.join(test_base, "image_2", f"{i:06d}.png"),
                      IMG_H, IMG_W)
            with open(os.path.join(test_base, "planes", f"{i:06d}.txt"),
                      "w") as f:
                f.write(f"# Plane\nWidth 4\nHeight 1\n0 -1 0 {GROUND_Y}\n")
            pts_rect, _ = make_scene(rng, n_points, k_max)
            velo = calib.rect_to_velo(pts_rect[:, :3])
            np.concatenate(
                [velo, pts_rect[:, 3:4]], 1
            ).astype(np.float32).tofile(
                os.path.join(test_base, "velodyne", f"{i:06d}.bin")
            )
        with open(os.path.join(root, "test.txt"), "w") as f:
            f.write("".join(f"{i:06d}\n" for i in range(n_test)))
    return root
