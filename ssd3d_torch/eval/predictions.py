"""Detection post-processing on the host: image-space boxes, KITTI dumps,
val-split inference + AP evaluation (counterpart of
`ssd3d/eval/predictions.py`).

The numpy parts are the original's (corner projection, the KITTI result
files, `evaluate_split`); `evaluate_recall` and `proposal_recall` take the
port's `core.iou.boxes_iou_bev_3d` on CPU tensors; `run_inference_on_split`
runs the port's `Pipeline.infer(points)` on the pipeline's device under
`torch.inference_mode()`, batching TEST.BATCH_SIZE scans on the one device.

Parity targets: reference kitti_dataloader.py:336-492 (evaluate_map /
save_predictions) and anchors_util.py:94 (corner projection, clipped to the
image)."""

from __future__ import annotations

import os

import numpy as np
import torch

from ssd3d_torch.core.iou import boxes_iou_bev_3d
from ssd3d_torch.eval.kitti_ap import EvalObject, evaluate_kitti_ap


def boxes_to_corners_np(boxes: np.ndarray) -> np.ndarray:
    """box_3d [n, 7] -> corners [n, 8, 3] (numpy twin of geometry.boxes_to_corners)."""
    x, y, z, l, h, w, ry = [boxes[:, i] for i in range(7)]
    zeros = np.zeros_like(l)
    xs = np.stack([l / 2, l / 2, -l / 2, -l / 2] * 2, 1)
    ys = np.stack([zeros, zeros, zeros, zeros, -h, -h, -h, -h], 1)
    zs = np.stack([w / 2, -w / 2, -w / 2, w / 2] * 2, 1)
    c, s = np.cos(ry), np.sin(ry)
    cx = c[:, None] * xs + s[:, None] * zs + x[:, None]
    cy = ys + y[:, None]
    cz = -s[:, None] * xs + c[:, None] * zs + z[:, None]
    return np.stack([cx, cy, cz], axis=-1)


def project_corners_to_image(corners: np.ndarray, P2: np.ndarray,
                             img_shape=(375, 1242)) -> np.ndarray:
    """corners [n, 8, 3] -> clipped 2D boxes [n, 4] = x1, y1, x2, y2."""
    n = len(corners)
    pts = corners.reshape(-1, 3)
    hom = np.concatenate([pts, np.ones((len(pts), 1), pts.dtype)], axis=1)
    uvw = hom @ P2.T
    uv = uvw[:, :2] / np.maximum(uvw[:, 2:3], 1e-6)
    uv = uv.reshape(n, 8, 2)
    h, w = img_shape
    x1 = np.clip(uv[:, :, 0].min(1), 0, w)
    x2 = np.clip(uv[:, :, 0].max(1), 0, w)
    y1 = np.clip(uv[:, :, 1].min(1), 0, h)
    y2 = np.clip(uv[:, :, 1].max(1), 0, h)
    return np.stack([x1, y1, x2, y2], axis=1)


def detections_to_eval_objects(boxes_3d, scores, classes, cls_list, P2,
                               img_shape=(375, 1242)) -> list:
    """Thresholded detections of one scan -> EvalObject list."""
    if len(boxes_3d) == 0:
        return []
    corners = boxes_to_corners_np(boxes_3d)
    box2d = project_corners_to_image(corners, P2, img_shape)
    out = []
    for i in range(len(boxes_3d)):
        b = boxes_3d[i]
        out.append(EvalObject(
            type=cls_list[int(classes[i])],
            box2d=box2d[i],
            t=b[0:3], l=float(b[3]), h=float(b[4]), w=float(b[5]),
            ry=float(b[6]),
            alpha=float(b[6] - np.arctan2(b[0], b[2])),
            score=float(scores[i]),
        ))
    return out


def labels_to_eval_objects(labels) -> list:
    """KittiLabel list -> EvalObject list (GT side)."""
    return [
        EvalObject(
            type=o.type, box2d=o.box2d,
            t=np.asarray(o.t), l=o.l, h=o.h, w=o.w, ry=o.ry, alpha=o.alpha,
            truncation=o.truncation, occlusion=o.occlusion,
        )
        for o in labels
    ]


def save_kitti_predictions(path: str, boxes_3d, scores, classes, cls_list,
                           P2, img_shape=(375, 1242)):
    """Write one KITTI-format result txt (kitti_dataloader.py:459-492)."""
    lines = []
    if len(boxes_3d):
        corners = boxes_to_corners_np(boxes_3d)
        box2d = project_corners_to_image(corners, P2, img_shape)
        for i in range(len(boxes_3d)):
            b = boxes_3d[i]
            lines.append(
                f"{cls_list[int(classes[i])]} 0.00 0 -10 "
                f"{box2d[i, 0]:.2f} {box2d[i, 1]:.2f} "
                f"{box2d[i, 2]:.2f} {box2d[i, 3]:.2f} "
                f"{b[4]:.2f} {b[5]:.2f} {b[3]:.2f} "
                f"{b[0]:.2f} {b[1]:.2f} {b[2]:.2f} {b[6]:.2f} "
                f"{scores[i]:.9f}\n"
            )
    with open(path, "w") as f:
        f.writelines(lines)


def run_inference_on_split(cfg, pipeline, loader, scene, cls_thresh=0.3,
                           save_dir=None, log=print, limit=None,
                           use_true_image_size=False, with_gt=True,
                           batch_size=1, viz_dir=None, viz_scans=4,
                           proposals_out=None):
    """Run `pipeline.infer(points) -> det dict` over a (val) split, on the
    device that holds the pipeline's weights: per-scan detections;
    optionally dumps KITTI txts. Returns (det_per_image, gt_per_image,
    names).

    batch_size > 1 runs `batch_size` scans a forward on the one device; the
    trailing partial batch is padded by repeating its last scan and the pad
    results dropped, as the JAX package does (where the batch is sharded
    over every visible device instead). The reference evaluator is strictly
    batch-1 (evaluator.py feed loop).

    2D-clip extent: the reference clips projected detection boxes to the
    hard-coded (375, 1242) default for EVERY scan (anchors_util.py:54
    default img_shape, called without the argument from
    kitti_dataloader.py:354 evaluate_map and :479 save_predictions), even
    though KITTI image sizes vary per scan — and the evaluator's
    min-height difficulty gate reads the clipped height. The default here
    keeps that parity; `use_true_image_size=True` clips to each scan's
    real PNG size instead (threaded from the preprocessed samples)."""
    cls_list = list(pipeline.cls_list)
    device = next(pipeline.model.parameters()).device
    det_per_image, gt_per_image, names = [], [], []
    count = 0
    done = False
    single_stream = loader.batches(1, epochs=1, num_threads=1, shuffle=False)

    def pull_block():
        block = []
        for b in single_stream:
            block.append(b)
            if len(block) == batch_size:
                break
        return block

    while not done:
        block = pull_block()
        if not block:
            break
        n_real = len(block)
        done = n_real < batch_size
        pts = np.concatenate(
            [b["points"] for b in block]
            + [block[-1]["points"]] * (batch_size - n_real)
        )
        with torch.inference_mode():
            dets = pipeline.infer(torch.from_numpy(pts).to(device))
        dets = {k: v.cpu().numpy() for k, v in dets.items()}
        for i in range(n_real):
            batch = block[i]
            det = {k: v[i] for k, v in dets.items()}
            if proposals_out is not None and "proposals" in det:
                # stage-1 proposal boxes (two-stage models), for recall:
                # the fixed-shape buffer and its mask
                proposals_out.append(
                    (det["proposals"], det["proposals_valid"])
                )
            keep = det["valid"] & (det["scores"] >= cls_thresh)
            boxes = det["boxes"][keep]
            scores = det["scores"][keep]
            classes = det["classes"][keep]
            name = int(batch["names"][0])
            P2 = batch["calib_P2"][0]
            img_shape = (375, 1242)
            if use_true_image_size and "image_size" in batch:
                img_shape = tuple(int(v) for v in batch["image_size"][0])
            det_per_image.append(
                detections_to_eval_objects(
                    boxes, scores, classes, cls_list, P2, img_shape
                )
            )
            # test-set mode (reference --no_gt, tester.py:27): no label files
            gt_per_image.append(
                labels_to_eval_objects(scene.labels(name)) if with_gt else []
            )
            names.append(name)
            if viz_dir and count < viz_scans:
                # 3D debug artifacts: points + GT + predictions (the
                # reference's mayavi draw_lidar/draw_gt_boxes3d use case,
                # viz_util.py:39,111), headless PNG + interactive HTML
                from ssd3d_torch.utils.viz import draw_scene_3d, dump_scene_html

                os.makedirs(viz_dir, exist_ok=True)
                gt_objs = gt_per_image[-1]
                gt_b = (np.stack(
                    [np.concatenate([g.t, [g.l, g.h, g.w, g.ry]])
                     for g in gt_objs]).astype(np.float32)
                    if gt_objs else np.zeros((0, 7), np.float32))
                draw_scene_3d(
                    batch["points"][0],
                    os.path.join(viz_dir, f"{name:06d}.png"),
                    gt_boxes=gt_b, pred_boxes=boxes, pred_scores=scores,
                    title=f"scan {name:06d}",
                )
                dump_scene_html(
                    batch["points"][0],
                    os.path.join(viz_dir, f"{name:06d}.html"),
                    gt_boxes=gt_b, pred_boxes=boxes,
                )
            if save_dir:
                os.makedirs(save_dir, exist_ok=True)
                save_kitti_predictions(
                    os.path.join(save_dir, f"{name:06d}.txt"),
                    boxes, scores, classes, cls_list, P2, img_shape,
                )
            count += 1
            if count % 200 == 0:
                log(f"inference {count} scans")
            if limit and count >= limit:
                done = True
                break
    return det_per_image, gt_per_image, names


def evaluate_recall(det_per_image, gt_boxes_per_image, iou_threshold=0.5):
    """Average recall over the split (reference TEST_MODE 'Recall',
    kitti_dataloader.py:385-408): a GT counts as detected when some
    prediction overlaps it with 3D IoU >= threshold."""
    detected, total = 0, 0
    for dets, gts in zip(det_per_image, gt_boxes_per_image):
        total += len(gts)
        if len(dets) == 0 or len(gts) == 0:
            continue
        pred = np.stack([np.concatenate([d.t, [d.l, d.h, d.w, d.ry]])
                         for d in dets]).astype(np.float32)
        _, iou3d = boxes_iou_bev_3d(torch.from_numpy(pred),
                                    torch.from_numpy(np.asarray(gts, np.float32)))
        hit = iou3d.numpy().max(axis=0) >= iou_threshold
        detected += int(hit.sum())
    return detected, total, detected / max(total, 1)


def proposal_recall(prop_boxes_per_image, gt_boxes_per_image,
                    iou_threshold=0.5):
    """Recall of raw stage-1 proposal boxes against GT at 3D IoU >=
    threshold — the quantity stage-2 refinement cannot recover (a GT no
    proposal covers is lost). Reference protocol: TEST_MODE 'Recall',
    kitti_dataloader.py:385-408.

    Entries of `prop_boxes_per_image` are either plain [P, 7] arrays
    (all valid) or ([P, 7], valid [P]) pairs."""
    total = int(sum(len(g) for g in gt_boxes_per_image))
    if total == 0 or not prop_boxes_per_image:
        return 0, total, 0.0
    detected = 0
    for entry, gts in zip(prop_boxes_per_image, gt_boxes_per_image):
        if len(gts) == 0:
            continue
        if isinstance(entry, tuple):
            props, valid = entry
        else:
            props = np.asarray(entry, np.float32)
            valid = np.ones((len(props),), bool)
        if len(props) == 0:
            continue
        _, iou3d = boxes_iou_bev_3d(torch.from_numpy(np.asarray(props, np.float32)),
                                    torch.from_numpy(np.asarray(gts, np.float32)))
        iou3d = torch.where(torch.from_numpy(np.asarray(valid, bool))[:, None], iou3d, 0.0)
        detected += int((iou3d.max(dim=0).values >= iou_threshold).sum())
    return detected, total, detected / max(total, 1)


def evaluate_split(cfg, det_per_image, gt_per_image, cls_list, log=print):
    """AP tables + the model-selection metric (Car moderate 3D, or mean
    Ped/Cyc moderate — kitti_dataloader.py:410-437)."""
    results = evaluate_kitti_ap(
        gt_per_image, det_per_image, tuple(cls_list), compute_aos=True
    )
    for cls_name, metrics in results.items():
        for metric, aps in metrics.items():
            log(f"{cls_name} {metric:6s} AP E/M/H: "
                + " ".join(f"{a:.2f}" for a in aps))
    if "Car" in cls_list:
        selection = results["Car"]["3d"][1]
    else:
        selection = (
            results["Pedestrian"]["3d"][1] + results["Cyclist"]["3d"][1]
        ) / 2.0
    return results, selection
