"""nuScenes data path (the port's copy of `ssd3d/data/nuscenes.py`, numpy
only): the frame casts, 10-sweep aggregation, the voxel budget, the loader
and the devkit-free raw-table converter.

1. 10-sweep point aggregation: each past sweep is rigid-transformed into the
   key frame and tagged with its time lag as an extra channel.
2. Frame cast to the framework-wide KITTI-style camera frame: (x, y, z) of
   the nuScenes lidar -> (x, -z, y), and boxes from centre / wlh / yaw to
   bottom centre / lhw / ry.
3. Voxel-budget sampling: dedupe the aggregated points through a voxel grid
   (at most MAX_NUMBER_OF_POINT_PER_VOXEL a voxel), key-frame points first,
   then a fixed point budget. The voxel cap runs in the port's `native/`
   (`voxelize.cc`) where g++ built it, else in numpy; both keep the same set.
4. Fixed-shape batches with velocity [g, 2] and attribute [g] labels for the
   velocity / attribute heads.

Every sample is a pure function of (seed, epoch, index): its voxel budget
draws from `np.random.SeedSequence([seed, epoch, index])`, in the order the
JAX package draws, so a batch equals the JAX package's bit for bit. Data on
disk: one .npz per key frame (`convert_raw_nuscenes` writes them).
"""

from __future__ import annotations

import os
import queue

import numpy as np

# nuScenes attribute vocabulary (8 entries; head predicts 8 logits)
NUSCENES_ATTRIBUTES = (
    "vehicle.moving", "vehicle.parked", "vehicle.stopped",
    "cycle.with_rider", "cycle.without_rider",
    "pedestrian.moving", "pedestrian.standing", "pedestrian.sitting_lying_down",
)


def cast_points_to_kitti(points: np.ndarray) -> np.ndarray:
    """nuScenes lidar frame (x right, y fwd, z up) -> camera-style
    (x right, y down, z fwd): (x, -z, y). Extra channels untouched."""
    out = points.copy()
    out[:, 1] = -points[:, 2]
    out[:, 2] = points[:, 1]
    return out


def cast_boxes_to_kitti(boxes: np.ndarray) -> np.ndarray:
    """boxes [n, 7] = (cx, cy, cz, w, l, h, yaw) nuScenes-style ->
    box_3d (x, y_bottom, z, l, h, w, ry) camera-style."""
    out = np.zeros_like(boxes)
    out[:, 0] = boxes[:, 0]
    out[:, 1] = -boxes[:, 2] + boxes[:, 5] / 2.0  # bottom face (y down)
    out[:, 2] = boxes[:, 1]
    out[:, 3] = boxes[:, 4]  # l
    out[:, 4] = boxes[:, 5]  # h
    out[:, 5] = boxes[:, 3]  # w
    out[:, 6] = -boxes[:, 6]
    return out


def aggregate_sweeps(key_points: np.ndarray, key_ts: float, sweeps: list,
                     feature_channels: int = 4) -> tuple[np.ndarray, int]:
    """Merge past sweeps into the key frame.

    key_points: [n, >=4] raw key-frame points (nuScenes frame)
    sweeps: list of dicts {points [m, >=4], rotation [3,3], translation [3],
            timestamp (s)}
    Returns (aggregated points cast to KITTI frame with Δt channel,
             key-frame point count). feature_channels==4 keeps (xyz, Δt);
    5 keeps (xyz, intensity, Δt)."""
    key = key_points.copy().astype(np.float32)
    if key.shape[1] == 4:
        key = np.concatenate([key, np.zeros((len(key), 1), np.float32)], 1)
    key[:, 3] /= 255.0
    key[:, 4] = 0.0
    parts = [key]
    for sweep in sweeps:
        pts = sweep["points"].copy().astype(np.float32)
        if pts.shape[1] == 4:
            pts = np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1)
        pts[:, 3] /= 255.0
        pts[:, :3] = pts[:, :3] @ np.asarray(sweep["rotation"], np.float32).T
        pts[:, :3] += np.asarray(sweep["translation"], np.float32)
        pts[:, 4] = key_ts - float(sweep["timestamp"])
        parts.append(pts)
    merged = np.concatenate(parts, axis=0)
    merged = cast_points_to_kitti(merged)
    if feature_channels == 4:
        merged = merged[:, [0, 1, 2, 4]]
    return merged, len(key)


def voxel_budget_sample(rng: np.random.Generator, points: np.ndarray,
                        voxel_size, point_range, max_per_voxel: int,
                        budget: int, priority_num: int = 0):
    """Density-capped point budget.

    Points are bucketed into a voxel grid; each voxel keeps at most
    `max_per_voxel` points (density normalization across near/far). The
    first `priority_num` input points (the key sweep) are kept preferentially,
    then the remainder fills up to `budget` (pad by resampling)."""
    vs = np.asarray(voxel_size, np.float32)
    ext = np.reshape(np.asarray(point_range, np.float32), [3, 2])
    lo = ext[:, 0]
    hi = ext[:, 1]

    from ssd3d_torch import native

    if native.load() is not None:
        keep = native.voxel_budget_flags_native(
            points, vs, lo, hi, max_per_voxel
        )
        kept = np.where(keep)[0]
    else:
        xyz = points[:, :3]
        inside = np.all((xyz > lo) & (xyz < hi), axis=1)
        idx_all = np.where(inside)[0]
        coords = np.floor((xyz[idx_all] - lo) / vs).astype(np.int64)
        grid = np.ceil((hi - lo) / vs).astype(np.int64)
        flat = (coords[:, 0] * grid[1] + coords[:, 1]) * grid[2] + coords[:, 2]

        # cap points per voxel (first-come order, like the numba kernel)
        order = np.argsort(flat, kind="stable")
        flat_sorted = flat[order]
        first = np.ones(len(flat_sorted), bool)
        first[1:] = flat_sorted[1:] != flat_sorted[:-1]
        group_start = np.maximum.accumulate(
            np.where(first, np.arange(len(first)), 0)
        )
        rank_in_voxel = np.arange(len(first)) - group_start
        keep_sorted = rank_in_voxel < max_per_voxel
        kept = np.sort(idx_all[order[keep_sorted]])

    key_kept = kept[kept < priority_num]
    other_kept = kept[kept >= priority_num]
    rng.shuffle(key_kept)
    rng.shuffle(other_kept)
    sel = np.concatenate([key_kept, other_kept])[:budget]
    if len(sel) == 0:
        sel = np.zeros(budget, np.int64)
    elif len(sel) < budget:
        pad = rng.choice(sel, budget - len(sel), replace=True)
        sel = np.concatenate([sel, pad])
    return points[sel]


MAX_GT_NUSC = 128


class NuScenesLoader:
    """Loads preprocessed nuScenes samples (one .npz per key frame) and emits
    fixed-shape batches with velocity/attribute targets."""

    def __init__(self, cfg, split: str, data_dir: str | None = None,
                 training: bool = True, seed: int = 0):
        ncfg = cfg.DATASET.NUSCENES
        self.cfg = cfg
        self.training = training
        self.seed = seed
        self.budget = ncfg.MAX_CUR_SAMPLE_POINTS_NUM
        self.feature_channels = ncfg.INPUT_FEATURE_CHANNEL
        self.data_dir = data_dir or os.path.join(ncfg.SAVE_NUMPY_PATH, split)
        with open(os.path.join(self.data_dir, "list.txt")) as f:
            self.names = [line.strip() for line in f if line.strip()]
        self.cls2idx = {c: i + 1 for i, c in enumerate(ncfg.CLS_LIST)}
        # no host augmentation chain on the nuScenes path (the reference's
        # nuScenes training never ran — SURVEY §2.9; the 10-sweep aggregate
        # plus voxel-budget resampling is already stochastic). The attribute
        # exists for the runtimes' loader interface.
        self.augmentor = None

    @property
    def sample_points_shape(self) -> tuple:
        """(points per scan, feature channels) of emitted batches."""
        return (self.budget, self.feature_channels)

    def __len__(self):
        return len(self.names)

    def load_sample(self, index: int, epoch_seed: int = 0) -> dict:
        """Sample .npz schema: points [n, 4/5] (already aggregated + cast),
        key_points_num int, boxes_3d [g, 7] (cast), classes [g] (names or
        ids), velocity [g, 2], attributes [g]."""
        name = self.names[index]
        data = np.load(os.path.join(self.data_dir, f"{name}.npz"),
                       allow_pickle=True)
        points = data["points"].astype(np.float32)
        key_num = int(data["key_points_num"]) if "key_points_num" in data else len(points)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch_seed, index])
        )
        points = voxel_budget_sample(
            rng, points,
            self.cfg.DATASET.VOXEL_SIZE,
            self.cfg.DATASET.POINT_CLOUD_RANGE,
            self.cfg.DATASET.MAX_NUMBER_OF_POINT_PER_VOXEL,
            self.budget, priority_num=key_num,
        )

        boxes = data["boxes_3d"].astype(np.float32) if "boxes_3d" in data else np.zeros((0, 7), np.float32)
        classes_raw = data["classes"] if "classes" in data else np.zeros((0,))
        if classes_raw.dtype.kind in ("U", "S", "O"):
            classes = np.array(
                [self.cls2idx.get(str(c), 0) for c in classes_raw], np.int32
            )
        else:
            classes = classes_raw.astype(np.int32)
        velocity = (
            data["velocity"].astype(np.float32)
            if "velocity" in data else np.zeros((len(boxes), 2), np.float32)
        )
        attributes = (
            data["attributes"].astype(np.int32)
            if "attributes" in data else np.full(len(boxes), -1, np.int32)
        )

        g = min(len(boxes), MAX_GT_NUSC)
        gt = np.zeros((MAX_GT_NUSC, 7), np.float32)
        labels = np.zeros((MAX_GT_NUSC,), np.int32)
        velo = np.zeros((MAX_GT_NUSC, 2), np.float32)
        attr = np.full((MAX_GT_NUSC,), -1, np.int32)
        gt[:g] = boxes[:g]
        labels[:g] = classes[:g]
        velo[:g] = velocity[:g]
        attr[:g] = attributes[:g]
        return {
            "points": points,
            "gt_boxes": gt,
            "gt_labels": labels,
            "gt_velocity": velo,
            "gt_attribute": attr,
            "name": name,
        }

    BATCH_KEYS = ("points", "gt_boxes", "gt_labels", "gt_velocity",
                  "gt_attribute")

    def batches(self, batch_size: int, epochs: int | None = None,
                shuffle: bool | None = None, num_threads: int = 0,
                num_procs: int = 0, start_iter: int = 0, mp_method: str = "fork"):
        """Deterministic (epoch, index)-pure batch stream. start_iter
        fast-forwards by that many batches without loading (batch-exact
        resume; see KittiLoader.batches).

        num_threads > 0 overlaps sample loading (npz IO + voxel budgeting)
        with consumption via a bounded thread pool; num_procs and mp_method
        are accepted for interface parity with KittiLoader (the nuScenes
        path has no host augmentation chain, so threads release the GIL in
        IO and suffice), as the JAX package accepts num_procs."""
        shuffle = self.training if shuffle is None else shuffle
        n = len(self.names)

        def index_stream():
            epoch = 0
            while epochs is None or epoch < epochs:
                order = (
                    np.random.default_rng(
                        np.random.SeedSequence([self.seed, epoch])
                    ).permutation(n)
                    if shuffle else np.arange(n)
                )
                for start in range(0, n - batch_size + 1, batch_size):
                    yield [(int(i), epoch)
                           for i in order[start:start + batch_size]]
                epoch += 1

        def index_stream_from():
            it = index_stream()
            for _ in range(start_iter):
                if next(it, None) is None:
                    return
            yield from it

        def assemble(samples):
            batch = {k: np.stack([s[k] for s in samples])
                     for k in self.BATCH_KEYS}
            batch["names"] = [s["name"] for s in samples]
            return batch

        if num_threads and num_threads > 0:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(num_threads) as pool:
                pending: queue.Queue = queue.Queue()
                stream = index_stream_from()
                depth = 2  # batches in flight
                try:
                    for _ in range(depth):
                        idxs = next(stream, None)
                        if idxs is None:
                            break
                        pending.put([pool.submit(self.load_sample, i, e)
                                     for i, e in idxs])
                    while not pending.empty():
                        futs = pending.get()
                        idxs = next(stream, None)
                        if idxs is not None:
                            pending.put([pool.submit(self.load_sample, i, e)
                                         for i, e in idxs])
                        yield assemble([f.result() for f in futs])
                finally:
                    while not pending.empty():
                        for f in pending.get():
                            f.cancel()
            return

        for idxs in index_stream_from():
            yield assemble([self.load_sample(i, e) for i, e in idxs])


# ---------------------------------------------------------------------------
# Raw nuScenes conversion — devkit-free. The dataset's tables are plain JSON
# and the point clouds are flat float32 .pcd.bin files, so the conversion the
# reference delegates to the nuscenes-devkit (nuscenes_dataloader.py:182-257)
# is re-implemented here with json + numpy only.

# standard detection-challenge category collapse
NUSC_CATEGORY_MAP = {
    "vehicle.car": "car",
    "vehicle.truck": "truck",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.trailer": "trailer",
    "vehicle.construction": "construction_vehicle",
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "vehicle.motorcycle": "motorcycle",
    "vehicle.bicycle": "bicycle",
    "movable_object.trafficcone": "traffic_cone",
    "movable_object.barrier": "barrier",
}


def quat_to_rot(q) -> np.ndarray:
    """nuScenes [w, x, y, z] quaternion -> 3x3 rotation matrix."""
    w, x, y, z = (float(v) for v in q)
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0.0 else 2.0 / n
    return np.array(
        [
            [1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w)],
            [s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w)],
            [s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)],
        ],
        np.float64,
    )


def _pose_mat(record) -> np.ndarray:
    """ego_pose / calibrated_sensor record -> homogeneous 4x4."""
    m = np.eye(4)
    m[:3, :3] = quat_to_rot(record["rotation"])
    m[:3, 3] = np.asarray(record["translation"], np.float64)
    return m


def _load_table(version_dir: str, name: str) -> dict:
    import json

    with open(os.path.join(version_dir, f"{name}.json")) as f:
        return {rec["token"]: rec for rec in json.load(f)}


def _read_lidar_bin(path: str) -> np.ndarray:
    """LIDAR_TOP .pcd.bin: flat float32 (x, y, z, intensity, ring) records.
    Returns [n, 4] (ring dropped)."""
    pts = np.fromfile(path, np.float32)
    return pts.reshape(-1, 5)[:, :4].copy()


def convert_raw_nuscenes(version: str, dataroot: str, out_dir: str,
                         nsweeps: int = 10, feature_channels: int = 4,
                         val_scenes=None, log=print):
    """Raw nuScenes tree -> one .npz per key frame (NuScenesLoader schema).

    version: e.g. 'v1.0-mini' / 'v1.0-trainval' (the table directory name
    under dataroot). val_scenes: iterable of scene names for the val split,
    or a path to a text file of them; default is every 5th scene (pass the
    official split list for challenge-comparable numbers).

    Per sample: sweeps are chained through sample_data['prev'], transformed
    into the key LIDAR frame via (ego_pose x calibrated_sensor) and tagged
    with their time lag; annotations are mapped to detection classes,
    velocities finite-differenced from the neighboring annotations of the
    same instance (NaN when isolated — the velocity loss masks NaNs); boxes
    and points are cast to the framework's camera-style frame."""
    version_dir = os.path.join(dataroot, version)
    scene = _load_table(version_dir, "scene")
    sample = _load_table(version_dir, "sample")
    sample_data = _load_table(version_dir, "sample_data")
    ego_pose = _load_table(version_dir, "ego_pose")
    calibrated = _load_table(version_dir, "calibrated_sensor")
    annotation = _load_table(version_dir, "sample_annotation")
    category = _load_table(version_dir, "category")
    attribute = _load_table(version_dir, "attribute")
    sensor = _load_table(version_dir, "sensor")
    instance = _load_table(version_dir, "instance")

    attr_idx = {
        rec["name"]: NUSCENES_ATTRIBUTES.index(rec["name"])
        for rec in attribute.values()
        if rec["name"] in NUSCENES_ATTRIBUTES
    }

    # key-frame LIDAR_TOP sample_data per sample
    key_sd = {}
    for sd in sample_data.values():
        ch = sensor[calibrated[sd["calibrated_sensor_token"]]["sensor_token"]]
        if ch["channel"] == "LIDAR_TOP" and sd["is_key_frame"]:
            key_sd[sd["sample_token"]] = sd

    # annotations per sample
    anns_of = {}
    for ann in annotation.values():
        anns_of.setdefault(ann["sample_token"], []).append(ann)

    if isinstance(val_scenes, str):
        with open(val_scenes) as f:
            val_scenes = {line.strip() for line in f if line.strip()}
    scenes_sorted = sorted(scene.values(), key=lambda s: s["name"])
    if val_scenes is None:
        val_scenes = {s["name"] for s in scenes_sorted[::5]}
    else:
        val_scenes = set(val_scenes)

    lists = {"train": [], "val": []}
    for sc in scenes_sorted:
        split = "val" if sc["name"] in val_scenes else "train"
        os.makedirs(os.path.join(out_dir, split), exist_ok=True)
        tok = sc["first_sample_token"]
        while tok:
            smp = sample[tok]
            sd = key_sd[tok]
            key_pose = _pose_mat(ego_pose[sd["ego_pose_token"]]) @ _pose_mat(
                calibrated[sd["calibrated_sensor_token"]]
            )
            key_inv = np.linalg.inv(key_pose)
            key_ts = smp["timestamp"] / 1e6

            key_pts = _read_lidar_bin(os.path.join(dataroot, sd["filename"]))
            sweeps = []
            prev_tok = sd["prev"]
            while prev_tok and len(sweeps) < nsweeps - 1:
                psd = sample_data[prev_tok]
                pose = _pose_mat(ego_pose[psd["ego_pose_token"]]) @ _pose_mat(
                    calibrated[psd["calibrated_sensor_token"]]
                )
                rel = key_inv @ pose  # sweep sensor -> key sensor
                sweeps.append(
                    {
                        "points": _read_lidar_bin(
                            os.path.join(dataroot, psd["filename"])
                        ),
                        "rotation": rel[:3, :3],
                        "translation": rel[:3, 3],
                        "timestamp": psd["timestamp"] / 1e6,
                    }
                )
                prev_tok = psd["prev"]

            points, key_num = aggregate_sweeps(
                key_pts, key_ts, sweeps, feature_channels=feature_channels
            )

            boxes, classes, velocity, attrs = [], [], [], []
            for ann in anns_of.get(tok, []):
                if ann.get("num_lidar_pts", 1) + ann.get("num_radar_pts", 0) == 0:
                    continue
                inst = instance[ann["instance_token"]]
                cat_name = category[inst["category_token"]]["name"]
                cls = NUSC_CATEGORY_MAP.get(cat_name)
                if cls is None:
                    continue
                # global -> key sensor frame
                ctr = key_inv[:3, :3] @ np.asarray(
                    ann["translation"], np.float64
                ) + key_inv[:3, 3]
                r_box = key_inv[:3, :3] @ quat_to_rot(ann["rotation"])
                yaw = float(np.arctan2(r_box[1, 0], r_box[0, 0]))
                w, l, h = (float(v) for v in ann["size"])
                boxes.append([ctr[0], ctr[1], ctr[2], w, l, h, yaw])
                classes.append(cls)
                velocity.append(
                    _ann_velocity(ann, annotation, sample, key_inv[:3, :3])
                )
                at = [attr_idx[attribute[t]["name"]]
                      for t in ann.get("attribute_tokens", [])
                      if attribute[t]["name"] in attr_idx]
                attrs.append(at[0] if at else -1)

            boxes_np = (
                cast_boxes_to_kitti(np.asarray(boxes, np.float32))
                if boxes else np.zeros((0, 7), np.float32)
            )
            name = tok
            np.savez_compressed(
                os.path.join(out_dir, split, f"{name}.npz"),
                points=points.astype(np.float32),
                key_points_num=np.int64(key_num),
                boxes_3d=boxes_np,
                classes=np.asarray(classes),
                velocity=np.asarray(velocity, np.float32).reshape(-1, 2),
                attributes=np.asarray(attrs, np.int32),
            )
            lists[split].append(name)
            tok = smp["next"]
        log(f"scene {sc['name']} -> {split}")

    for split, names in lists.items():
        if names:
            with open(os.path.join(out_dir, split, "list.txt"), "w") as f:
                f.write("\n".join(names) + "\n")
    log(f"wrote {len(lists['train'])} train / {len(lists['val'])} val samples")
    return lists


def _ann_velocity(ann, annotation, sample, rot_inv) -> tuple:
    """Finite-difference velocity of an annotation (global frame, like the
    devkit's box_velocity), rotated into the key sensor frame and cast to
    the camera-style horizontal plane (vx, vz). NaN when the instance has
    no temporal neighbors (the velocity loss masks NaNs)."""
    first = annotation.get(ann["prev"]) if ann.get("prev") else None
    last = annotation.get(ann["next"]) if ann.get("next") else None
    a = first if first is not None else ann
    b = last if last is not None else ann
    if a is b:
        return (np.nan, np.nan)
    dt = (
        sample[b["sample_token"]]["timestamp"]
        - sample[a["sample_token"]]["timestamp"]
    ) / 1e6
    if dt <= 0:
        return (np.nan, np.nan)
    v_global = (
        np.asarray(b["translation"], np.float64)
        - np.asarray(a["translation"], np.float64)
    ) / dt
    v_sensor = rot_inv @ v_global
    # cast (x, y, z) -> (x, -z, y): horizontal plane is (x_cam, z_cam)
    return (float(v_sensor[0]), float(v_sensor[1]))
