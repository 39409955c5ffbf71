"""Synthetic raw nuScenes tree (the port's copy of the scene writer of
`tools/synth_nuscenes.py`), for end-to-end runs without real data.

Emits a disk-format v1.0 tree, JSON tables and flat-float32 LIDAR .pcd.bin
files, that `ssd3d_torch.data.nuscenes.convert_raw_nuscenes` (and so
`bin.preprocess` with DATASET.TYPE NuScenes) consumes: multi-sample scenes
with a moving ego, chained sweeps between key frames, and annotated
instances (moving and parked cars, pedestrians, traffic cones, barriers)
whose prev / next links give the converter real finite-difference
velocities.

Geometry is generated in the nuScenes LIDAR convention (x right, y forward,
z up; ground at z = -1.8 below the sensor): a ground disc, box / cylinder
surface shells per object, and uniform clutter. Every frame's points are
produced at that frame's timestamp from each object's motion model, so sweep
aggregation sees displaced returns.
"""

from __future__ import annotations

import json
import os

import numpy as np

GROUND_Z = -1.8
EGO_SPEED = 5.0  # m/s along +y
KEY_DT = 0.5  # s between key frames
SWEEPS_BETWEEN = 1  # intermediate sweeps per key interval


def _yaw_quat(yaw: float) -> list:
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def sample_objects(rng: np.random.Generator, k_cars=5, k_peds=3, k_static=3):
    """Object set for one scene: dicts with category, size (w, l, h),
    initial global center, yaw, velocity (global m/s), attribute name.

    Placements are rejection-sampled so no two objects spawn within 4 m
    (BEV centers): overlapping shells merge into unlearnable blobs and
    cap recall on the small static classes (barrier/traffic cone)."""

    def clear(center, objs, min_d=4.0):
        return all(
            np.hypot(center[0] - o["center"][0], center[1] - o["center"][1])
            >= min_d for o in objs
        )

    def place(draw, objs, tries=25):
        for _ in range(tries):
            c = draw()
            if clear(c, objs):
                return c
        return None

    objs = []
    for _ in range(k_cars):
        moving = rng.random() < 0.5
        speed = rng.uniform(3.0, 8.0) if moving else 0.0
        heading = rng.choice([np.pi / 2, -np.pi / 2])  # along +-y
        w = rng.uniform(1.7, 2.0)
        l = rng.uniform(4.0, 5.0)
        h = rng.uniform(1.5, 1.9)
        c = place(lambda: np.array([rng.uniform(-15, 15),
                                    rng.uniform(8, 40),
                                    GROUND_Z + h / 2]), objs)
        if c is None:
            continue
        objs.append(dict(
            category="vehicle.car", size=(w, l, h),
            center=c,
            yaw=float(heading),
            vel=np.array([np.cos(heading), np.sin(heading), 0.0]) * speed,
            attribute="vehicle.moving" if moving else "vehicle.parked",
        ))
    for _ in range(k_peds):
        moving = rng.random() < 0.6
        speed = rng.uniform(0.5, 1.5) if moving else 0.0
        ang = rng.uniform(0, 2 * np.pi)
        h = rng.uniform(1.5, 1.9)
        c = place(lambda: np.array([rng.uniform(-12, 12),
                                    rng.uniform(6, 30),
                                    GROUND_Z + h / 2]), objs)
        if c is None:
            continue
        objs.append(dict(
            category="human.pedestrian.adult", size=(0.6, 0.6, h),
            center=c,
            yaw=float(ang),
            vel=np.array([np.cos(ang), np.sin(ang), 0.0]) * speed,
            attribute=("pedestrian.moving" if moving
                       else "pedestrian.standing"),
        ))
    for i in range(k_static):
        # alternate deterministically so cones and barriers both get a
        # full half of the static budget in every scene
        if i % 2 == 0:
            c = place(lambda: np.array([rng.uniform(-10, 10),
                                        rng.uniform(5, 25),
                                        GROUND_Z + 0.35]), objs)
            if c is None:
                continue
            objs.append(dict(
                category="movable_object.trafficcone", size=(0.3, 0.3, 0.7),
                center=c,
                yaw=0.0, vel=np.zeros(3), attribute=None,
            ))
        else:
            c = place(lambda: np.array([rng.uniform(-12, 12),
                                        rng.uniform(5, 30),
                                        GROUND_Z + 0.5]), objs)
            if c is None:
                continue
            objs.append(dict(
                category="movable_object.barrier", size=(2.5, 0.5, 1.0),
                center=c,
                yaw=float(rng.uniform(0, np.pi)), vel=np.zeros(3),
                attribute=None,
            ))
    return objs


def _obj_center_at(obj, t: float) -> np.ndarray:
    return obj["center"] + obj["vel"] * t


def _box_shell(rng, center, size, yaw, n):
    """n points on the surface of an upright box sized (w, l, h), yaw about
    z. nuScenes box frame: x-axis = heading = length, y-axis = width."""
    w, l, h = size
    face = rng.integers(0, 5, n)  # 4 sides + top
    u = rng.uniform(-0.5, 0.5, n)
    v = rng.uniform(-0.5, 0.5, n)
    x = np.where(face == 0, -l / 2, np.where(face == 1, l / 2, u * l))
    y = np.where(face == 2, -w / 2, np.where(face == 3, w / 2, u * w))
    y = np.where(face < 2, v * w, y)
    z = np.where(face == 4, h / 2, v * h)
    c, s = np.cos(yaw), np.sin(yaw)
    gx = c * x - s * y + center[0]
    gy = s * x + c * y + center[1]
    gz = z + center[2]
    pts = np.stack([gx, gy, gz], 1)
    return pts + rng.normal(0, 0.01, pts.shape)


def _cylinder_shell(rng, center, size, n):
    w, _, h = size
    ang = rng.uniform(0, 2 * np.pi, n)
    r = w / 2
    z = rng.uniform(-h / 2, h / 2, n)
    pts = np.stack([r * np.cos(ang) + center[0],
                    r * np.sin(ang) + center[1],
                    z + center[2]], 1)
    return pts + rng.normal(0, 0.01, pts.shape)


def frame_points(rng, objs, ego_pos, t, n_points=12000):
    """One frame's cloud in the sensor frame at time t (sensor at ego_pos,
    axis-aligned). Returns [n, 5] (x, y, z, intensity, ring-placeholder)."""
    n_ground = int(n_points * 0.55)
    n_clutter = int(n_points * 0.1)
    parts = []
    gx = rng.uniform(-40, 40, n_ground)
    gy = rng.uniform(-40, 45, n_ground)
    gz = np.full(n_ground, GROUND_Z) + rng.normal(0, 0.02, n_ground)
    parts.append(np.stack([gx, gy, gz], 1))
    parts.append(np.stack([
        rng.uniform(-40, 40, n_clutter),
        rng.uniform(-40, 45, n_clutter),
        rng.uniform(GROUND_Z, 3.0, n_clutter),
    ], 1))
    n_obj = n_points - n_ground - n_clutter
    per = max(n_obj // max(len(objs), 1), 1)
    for obj in objs:
        c_global = _obj_center_at(obj, t)
        c = c_global - ego_pos
        # surface density falls off with range
        dist = float(np.linalg.norm(c[:2]))
        k = max(int(per * min(1.0, 20.0 / max(dist, 1.0))), 8)
        if obj["category"] in ("human.pedestrian.adult",
                               "movable_object.trafficcone"):
            parts.append(_cylinder_shell(rng, c, obj["size"], k))
        else:
            parts.append(_box_shell(rng, c, obj["size"], obj["yaw"], k))
    pts = np.concatenate(parts, 0)
    out = np.zeros((len(pts), 5), np.float32)
    out[:, :3] = pts
    out[:, 3] = rng.uniform(0, 255, len(pts))
    return out


def write_tree(root: str, n_scenes=5, samples_per_scene=6, n_points=12000,
               seed=0, version="v1.0-synth", val_every=5, k_static=3):
    """Write the raw tree; every `val_every`-th scene (sorted by name) goes
    to val via the converter's default rule. Returns the version string."""
    rng = np.random.default_rng(seed)
    version_dir = os.path.join(root, version)
    os.makedirs(version_dir, exist_ok=True)
    os.makedirs(os.path.join(root, "samples/LIDAR_TOP"), exist_ok=True)
    os.makedirs(os.path.join(root, "sweeps/LIDAR_TOP"), exist_ok=True)

    qid = [1.0, 0.0, 0.0, 0.0]
    tables = {name: [] for name in (
        "sensor", "calibrated_sensor", "ego_pose", "scene", "sample",
        "sample_data", "category", "attribute", "instance",
        "sample_annotation",
    )}
    tables["sensor"].append({"token": "SEN", "channel": "LIDAR_TOP"})
    tables["calibrated_sensor"].append(
        {"token": "CS", "sensor_token": "SEN", "rotation": qid,
         "translation": [0, 0, 0]}
    )
    categories = {}
    attributes = {}

    def cat_token(name):
        if name not in categories:
            tok = f"CAT{len(categories)}"
            categories[name] = tok
            tables["category"].append({"token": tok, "name": name})
        return categories[name]

    def attr_token(name):
        if name not in attributes:
            tok = f"ATT{len(attributes)}"
            attributes[name] = tok
            tables["attribute"].append({"token": tok, "name": name})
        return attributes[name]

    sweep_dt = KEY_DT / (SWEEPS_BETWEEN + 1)
    for si in range(n_scenes):
        scene_name = f"scene-{si + 1:04d}"
        objs = sample_objects(rng, k_static=k_static)
        inst_tokens = []
        for oi, obj in enumerate(objs):
            tok = f"I{si}_{oi}"
            inst_tokens.append(tok)
            tables["instance"].append(
                {"token": tok, "category_token": cat_token(obj["category"])}
            )

        sample_toks = [f"S{si}_{k}" for k in range(samples_per_scene)]
        tables["scene"].append({"token": f"SC{si}", "name": scene_name,
                                "first_sample_token": sample_toks[0]})

        # ego: straight line along +y, offset per scene so scenes differ
        ego0 = np.array([rng.uniform(-3, 3), rng.uniform(-5, 0), 0.0])

        prev_sd = ""
        ann_prev = {tok: "" for tok in inst_tokens}
        for k in range(samples_per_scene):
            t_key = k * KEY_DT
            ts_key = int(t_key * 1e6)
            stok = sample_toks[k]
            tables["sample"].append({
                "token": stok, "timestamp": ts_key,
                "prev": sample_toks[k - 1] if k else "",
                "next": sample_toks[k + 1] if k + 1 < samples_per_scene else "",
                "scene_token": f"SC{si}",
            })

            # intermediate sweeps leading into this key frame
            frame_specs = []
            if k:
                for j in range(1, SWEEPS_BETWEEN + 1):
                    frame_specs.append(("sweep", (k - 1) * KEY_DT + j * sweep_dt))
            frame_specs.append(("key", t_key))

            for kind, t in frame_specs:
                ego = ego0 + np.array([0.0, EGO_SPEED * t, 0.0])
                ts = int(t * 1e6)
                sd_tok = f"SD{si}_{ts}"
                sub = "samples" if kind == "key" else "sweeps"
                rel = f"{sub}/LIDAR_TOP/{sd_tok}.pcd.bin"
                pts = frame_points(rng, objs, ego, t, n_points)
                pts.tofile(os.path.join(root, rel))
                ep_tok = f"EP{si}_{ts}"
                tables["ego_pose"].append({
                    "token": ep_tok, "rotation": qid,
                    "translation": [float(v) for v in ego],
                })
                tables["sample_data"].append({
                    "token": sd_tok, "sample_token": stok,
                    "ego_pose_token": ep_tok, "calibrated_sensor_token": "CS",
                    "is_key_frame": kind == "key", "filename": rel,
                    "prev": prev_sd, "next": "", "timestamp": ts,
                })
                if prev_sd:
                    tables["sample_data"][-2]["next"] = sd_tok
                prev_sd = sd_tok

            # annotations at the key frame
            for oi, obj in enumerate(objs):
                c = _obj_center_at(obj, t_key)
                ann_tok = f"A{si}_{oi}_{k}"
                w, l, h = obj["size"]
                rec = {
                    "token": ann_tok, "sample_token": stok,
                    "instance_token": inst_tokens[oi],
                    "translation": [float(v) for v in c],
                    "size": [float(w), float(l), float(h)],
                    "rotation": _yaw_quat(obj["yaw"]),
                    "prev": ann_prev[inst_tokens[oi]], "next": "",
                    "num_lidar_pts": 8, "num_radar_pts": 0,
                    "attribute_tokens": (
                        [attr_token(obj["attribute"])]
                        if obj["attribute"] else []
                    ),
                }
                if ann_prev[inst_tokens[oi]]:
                    prev_rec = next(
                        a for a in tables["sample_annotation"]
                        if a["token"] == ann_prev[inst_tokens[oi]]
                    )
                    prev_rec["next"] = ann_tok
                ann_prev[inst_tokens[oi]] = ann_tok
                tables["sample_annotation"].append(rec)

    for name, recs in tables.items():
        with open(os.path.join(version_dir, f"{name}.json"), "w") as f:
            json.dump(recs, f)
    return version
