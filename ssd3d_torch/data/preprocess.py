"""Offline KITTI preprocessing (reference lib/core/data_preprocessor.py +
kitti_dataloader.py:173-323).

The port's copy of `ssd3d/data/preprocess.py` (numpy only;
tests/test_torch_data.py holds the two to the same outputs).

Per scan: velodyne -> rect projection, image-frustum AND range crop, GT boxes
+ per-point semantic labels from 0.1-enlarged boxes, skip scans with no
foreground class or no foreground point; dump one .npz per scan plus the
per-class GT-crop "mixup" database (interior points of boxes with >= 5 pts).

float32 bit-parity notes: the projection chain is (pts @ V2C^T) @ R0^T in
f32, identical op order to the reference Calibration; frustum test uses the
true image size; range filter uses strict inequalities on
DATASET.POINT_CLOUD_RANGE reshaped [3, 2].
"""

from __future__ import annotations

import os

import numpy as np

from ssd3d_torch.data.augment import points_in_boxes_np
from ssd3d_torch.data.kitti_io import KittiScene


def frustum_range_filter(points_rect, calib, image_size, extents):
    """Keep points projecting inside the image with z >= 0 AND inside the
    3D range box (points_filter.py:8-52)."""
    h, w = image_size
    uv = calib.rect_to_image(points_rect)
    img_ok = (
        (uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) & (uv[:, 1] < h)
        & (points_rect[:, 2] >= 0)
    )
    ext = np.reshape(np.asarray(extents, np.float32), [3, 2])
    range_ok = (
        (points_rect[:, 0] > ext[0, 0]) & (points_rect[:, 0] < ext[0, 1])
        & (points_rect[:, 1] > ext[1, 0]) & (points_rect[:, 1] < ext[1, 1])
        & (points_rect[:, 2] > ext[2, 0]) & (points_rect[:, 2] < ext[2, 1])
    )
    return img_ok & range_ok


def preprocess_sample(scene: KittiScene, idx: int, cls_list, extents,
                      with_gt: bool, expand: float = 0.1,
                      min_points: int = 5):
    """One scan -> sample dict, or None if it must be skipped
    (no foreground object / no foreground point, kitti_dataloader.py:203-228)."""
    calib = scene.calib(idx)
    velo = scene.lidar(idx)
    intensity = velo[:, 3:]
    pts = calib.velo_to_rect(velo[:, :3]).astype(np.float32)

    keep = frustum_range_filter(pts, calib, scene.image_size(idx), extents)
    pts, intensity = pts[keep], intensity[keep]

    cls2idx = {c: i + 1 for i, c in enumerate(cls_list)}
    sample = {
        "name": idx,
        "calib_P2": calib.P,
        "image_size": np.asarray(scene.image_size(idx), np.int32),
    }

    if with_gt:
        objs = [o for o in scene.labels(idx) if o.type in cls_list]
        if not objs:
            return None
        boxes = np.stack([o.box_3d for o in objs]).astype(np.float32)
        classes = np.array([cls2idx[o.type] for o in objs], np.int32)
        inside = points_in_boxes_np(pts, boxes, expand=expand)  # [pts, gt]
        cls_per_pt = classes[np.argmax(inside, axis=1)]
        sem_labels = (inside.any(axis=1) * cls_per_pt).astype(np.int32)
        if sem_labels.sum() == 0:
            return None
        sample.update(
            boxes_3d=boxes, classes=classes, sem_labels=sem_labels,
            sem_dists=np.ones_like(sem_labels, np.float32),
        )
    else:
        sample.update(
            sem_labels=np.ones(len(pts), np.int32),
            sem_dists=np.ones(len(pts), np.float32),
        )

    sample["points"] = np.concatenate([pts, intensity], axis=-1).astype(
        np.float32
    )
    return sample


def mixup_crops(sample: dict, idx2cls, expand: float = 0.1, min_points: int = 5):
    """Per-GT interior-point crops for the mixup database
    (kitti_dataloader.py:258-287)."""
    boxes, classes, pts = sample["boxes_3d"], sample["classes"], sample["points"]
    inside = points_in_boxes_np(pts, boxes, expand=expand)
    counts = inside.sum(axis=0)
    crops = []
    for g in np.where(counts >= min_points)[0]:
        crops.append({
            "points": pts[inside[:, g]],
            "box_3d": boxes[g],
            "class": idx2cls[int(classes[g])],
        })
    return crops


def run_preprocess(cfg, img_list: str = "train", out_dir: str | None = None,
                   limit: int | None = None, log=print):
    """Full offline pass: per-scan .npz files + list file + mixup database
    (the data_preprocessor.py CLI body)."""
    kcfg = cfg.DATASET.KITTI
    cls_list = list(kcfg.CLS_LIST)
    idx2cls = {i + 1: c for i, c in enumerate(cls_list)}
    split = "testing" if img_list == "test" else "training"
    scene = KittiScene(kcfg.BASE_DIR_PATH, split)
    list_file = {
        "train": kcfg.TRAIN_LIST, "val": kcfg.VAL_LIST,
        "trainval": kcfg.TRAINVAL_LIST, "test": kcfg.TEST_LIST,
    }[img_list]
    with open(list_file) as f:
        indices = [int(line.strip()) for line in f if line.strip()]
    if limit:
        indices = indices[:limit]

    out_dir = out_dir or os.path.join(kcfg.SAVE_NUMPY_PATH, img_list)
    os.makedirs(out_dir, exist_ok=True)
    with_gt = img_list in ("train", "val", "trainval") and cfg.TEST.WITH_GT
    build_mixup = with_gt and cfg.TRAIN.AUGMENTATIONS.MIXUP.OPEN

    mixup_db: dict = {c: [] for c in cfg.TRAIN.AUGMENTATIONS.MIXUP.CLASS}
    kept = []
    for i in indices:
        sample = preprocess_sample(
            scene, i, cls_list, cfg.DATASET.POINT_CLOUD_RANGE, with_gt,
            expand=cfg.TRAIN.AUGMENTATIONS.EXPAND_DIMS_LENGTH,
            min_points=cfg.DATASET.MIN_POINTS_NUM,
        )
        if sample is None:
            continue
        np.savez(os.path.join(out_dir, f"{i:06d}.npz"), **sample)
        kept.append(i)
        if build_mixup:
            for crop in mixup_crops(
                sample, idx2cls,
                expand=cfg.TRAIN.AUGMENTATIONS.EXPAND_DIMS_LENGTH,
                min_points=cfg.DATASET.MIN_POINTS_NUM,
            ):
                if crop["class"] in mixup_db:
                    mixup_db[crop["class"]].append(crop)

    with open(os.path.join(out_dir, "list.txt"), "w") as f:
        f.writelines(f"{i:06d}\n" for i in kept)
    log(f"preprocessed {len(kept)}/{len(indices)} scans -> {out_dir}")

    if build_mixup:
        db_root = os.path.join(
            kcfg.SAVE_NUMPY_PATH, cfg.TRAIN.AUGMENTATIONS.MIXUP.SAVE_NUMPY_PATH,
            cfg.TRAIN.AUGMENTATIONS.MIXUP.PC_LIST,
        )
        for cls_name, crops in mixup_db.items():
            cls_dir = os.path.join(db_root, cls_name)
            os.makedirs(cls_dir, exist_ok=True)
            for j, crop in enumerate(crops):
                np.savez(os.path.join(cls_dir, f"{j:06d}.npz"),
                         points=crop["points"], box_3d=crop["box_3d"])
            with open(os.path.join(cls_dir, "list.txt"), "w") as f:
                f.writelines(f"{j:06d}\n" for j in range(len(crops)))
            log(f"mixup db {cls_name}: {len(crops)} crops")
    return kept
