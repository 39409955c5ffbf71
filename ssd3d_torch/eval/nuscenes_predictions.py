"""nuScenes val-split inference, mAP / NDS evaluation and the submission dump
(counterpart of `ssd3d/eval/nuscenes_predictions.py`).

The numpy parts are the original's (`detections_to_nusc_boxes`,
`gt_batch_to_nusc_boxes`, the submission records and JSON, `evaluate_split`);
`run_inference_on_split` runs the port's `Pipeline.infer(points)` on the
pipeline's device under `torch.inference_mode()`, batching TEST.BATCH_SIZE
scans on the one device through `eval/predictions.scan_blocks`, as the
KITTI driver does. The dump
follows the official submission schema (results keyed by sample token) but
keeps boxes in the framework-wide camera-style frame, documented per record.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ssd3d_torch.eval.nuscenes_eval import NuscBox, evaluate_nuscenes
from ssd3d_torch.eval.predictions import scan_blocks


def detections_to_nusc_boxes(boxes, scores, classes, cls_list,
                             velocity=None, attr_logits=None) -> list:
    """One scan's thresholded detections -> NuscBox list.

    boxes [n, 7] box_3d; velocity [n, 2] (vx, vz) or None; attr_logits
    [n, 8] head logits or None (argmax -> attribute id)."""
    out = []
    for i in range(len(boxes)):
        b = np.asarray(boxes[i], np.float64)
        out.append(NuscBox(
            cls=cls_list[int(classes[i])],
            center=b[0:3],
            size=b[3:6],
            ry=float(b[6]),
            velocity=(np.asarray(velocity[i], np.float64)
                      if velocity is not None else np.zeros(2)),
            attribute=(int(np.argmax(attr_logits[i]))
                       if attr_logits is not None else -1),
            score=float(scores[i]),
        ))
    return out


def gt_batch_to_nusc_boxes(gt_boxes, gt_labels, cls_list,
                           gt_velocity=None, gt_attribute=None) -> list:
    """One scan's padded GT arrays -> NuscBox list (labels are 1-based,
    0 = padding)."""
    out = []
    for i in range(len(gt_boxes)):
        lab = int(gt_labels[i])
        if lab <= 0:
            continue
        b = np.asarray(gt_boxes[i], np.float64)
        out.append(NuscBox(
            cls=cls_list[lab - 1],
            center=b[0:3],
            size=b[3:6],
            ry=float(b[6]),
            velocity=(np.asarray(gt_velocity[i], np.float64)
                      if gt_velocity is not None else np.zeros(2)),
            attribute=(int(gt_attribute[i])
                       if gt_attribute is not None else -1),
        ))
    return out


def submission_records(name, boxes: list) -> list:
    """One scan's NuscBox detections -> its submission records (camera-frame
    boxes, keyed by the sample token `name`)."""
    return [
        {
            "sample_token": str(name),
            "translation_cam": [float(v) for v in b.center],
            "size_lhw": [float(v) for v in b.size],
            "yaw_cam": b.ry,
            "velocity_cam": [float(v) for v in b.velocity],
            "detection_name": b.cls,
            "detection_score": b.score,
            "attribute_id": b.attribute,
        }
        for b in boxes
    ]


def run_inference_on_split(cfg, pipeline, loader, cls_thresh=0.0, save_path=None,
                           log=print, limit=None, batch_size=1):
    """Run `pipeline.infer(points) -> det dict` over a NuScenesLoader split,
    on the device that holds the pipeline's weights.

    Returns (det_per_frame, gt_per_frame, names) as NuscBox lists. When
    `save_path` is given, also writes the submission-style JSON. batch_size
    > 1 runs `batch_size` scans a forward on the one device
    (`predictions.scan_blocks`)."""
    cls_list = list(pipeline.cls_list)
    dets, gts, names = [], [], []
    dump = {}
    count = 0
    for block, out in scan_blocks(loader, batch_size, pipeline, limit):
        for i, batch in enumerate(block):
            det = {k: v[i] for k, v in out.items()}
            keep = det["valid"] & (det["scores"] >= cls_thresh)
            velocity = det["velocity"][keep] if "velocity" in det else None
            attr = det["attribute"][keep] if "attribute" in det else None
            dets.append(detections_to_nusc_boxes(
                det["boxes"][keep], det["scores"][keep], det["classes"][keep], cls_list,
                velocity, attr))
            gts.append(gt_batch_to_nusc_boxes(
                batch["gt_boxes"][0], batch["gt_labels"][0], cls_list,
                batch["gt_velocity"][0] if "gt_velocity" in batch else None,
                batch["gt_attribute"][0] if "gt_attribute" in batch else None))
            name = batch["names"][0]
            names.append(name)
            if save_path is not None:
                dump[str(name)] = submission_records(name, dets[-1])
            count += 1
            if count % 200 == 0:
                log(f"inference {count} frames")
    if save_path is not None:
        os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
        with open(save_path, "w") as f:
            json.dump({"meta": {"use_lidar": True}, "results": dump}, f)
    return dets, gts, names


def evaluate_split(cfg, det_per_frame, gt_per_frame, cls_list, log=print):
    """mAP / NDS tables and the NDS selection metric (the nuScenes analogue
    of predictions.evaluate_split's Car-Moderate-3D), in percent."""
    results = evaluate_nuscenes(gt_per_frame, det_per_frame, list(cls_list))
    for cls_name, entry in results["per_class"].items():
        errs = " ".join(
            f"{k}={entry[k]:.3f}" for k in ("trans", "scale", "orient",
                                            "vel", "attr") if k in entry
        )
        log(f"{cls_name:20s} mAP {entry['mean_ap']:.4f} {errs}")
    log(f"mAP {results['mAP']:.4f} NDS {results['NDS']:.4f}")
    return results, float(results["NDS"]) * 100.0
