"""Continuous-eval daemon / one-shot evaluation (counterpart of
`ssd3d/bin/evaluate.py`, the reference's lib/core/evaluator.py), on one
device: the card unless `--device cpu`.

Polls the checkpoint dir, evaluates new checkpoints on the val split, keeps
the best by Car-Moderate-3D AP (or mean Ped/Cyc), and copies the best
checkpoint aside (evaluator.py:94-135). Takes single-stage (3DSSD) and
two-stage (PointRCNN) configs through `models.api.build_pipeline`.

    python -m ssd3d_torch.bin.evaluate --cfg <yaml> --log_dir runs/3dssd \
        [--once] [--cls_threshold 0.3] [--limit N] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time

import numpy as np

from ssd3d_torch.bin import cli_device
from ssd3d_torch.config import load_cfg
from ssd3d_torch.data import build_loader
from ssd3d_torch.data.kitti_io import KittiScene
from ssd3d_torch.eval.predictions import (
    evaluate_recall,
    evaluate_split,
    proposal_recall,
    run_inference_on_split,
)
from ssd3d_torch.models.api import build_pipeline
from ssd3d_torch.train.trainer import CheckpointManager, restore_from_path


def _gt_boxes(gt, wanted=None):
    """Per-scan GT EvalObjects -> [k, 7] box arrays (of the `wanted`
    classes only, when given)."""
    out = []
    for frame in gt:
        rows = [np.concatenate([g.t, [g.l, g.h, g.w, g.ry]]) for g in frame
                if wanted is None or g.type in wanted]
        out.append(np.stack(rows).astype(np.float32) if rows else np.zeros((0, 7), np.float32))
    return out


def evaluate_checkpoint(cfg, pipeline, split="val", cls_thresh=0.3, limit=None,
                        log=print, viz_dir=None, viz_scans=0):
    """The pipeline (its weights loaded) over a split -> (results, the
    model-selection metric)."""
    if cfg.DATASET.TYPE.upper() == "NUSCENES":
        raise NotImplementedError("bin.evaluate: nuScenes is not ported yet "
                                  "(ROADMAP Queue 1 item 11)")
    loader = build_loader(cfg, split, training=False)
    scene = KittiScene(cfg.DATASET.KITTI.BASE_DIR_PATH, "training")
    props = []  # stage-1 proposals (two-stage models only)
    det, gt, _ = run_inference_on_split(
        cfg, pipeline, loader, scene, cls_thresh=cls_thresh, log=log, limit=limit,
        batch_size=cfg.TEST.BATCH_SIZE, viz_dir=viz_dir, viz_scans=viz_scans,
        proposals_out=props,
    )
    if cfg.TEST.TEST_MODE == "Recall":
        detected, total, recall = evaluate_recall(det, _gt_boxes(gt))
        log(f"recall: {detected}/{total} = {recall:.4f}")
        return {"recall": recall, "detected": detected, "total": total}, recall
    results, selection = evaluate_split(cfg, det, gt, pipeline.cls_list, log=log)
    if props:
        # recall only against GTs of the model's classes: the Car-only
        # RPN is not supposed to propose pedestrians/cyclists/vans
        wanted = set(pipeline.cls_list)
        detected, total, recall = proposal_recall(props, _gt_boxes(gt, wanted))
        log(f"proposal recall@0.5 ({'/'.join(sorted(wanted))}): "
            f"{detected}/{total} = {recall:.4f}")
        results["proposal_recall"] = {
            "iou": 0.5, "detected": detected, "total": total, "recall": recall,
        }
    return results, selection


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser(prog="python -m ssd3d_torch.bin.evaluate")
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--log_dir", required=True)
    ap.add_argument("--split", default="val")
    ap.add_argument("--cls_threshold", type=float, default=0.3)
    ap.add_argument("--eval_interval_secs", type=int, default=300)
    ap.add_argument("--once", action="store_true")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--viz_scans", type=int, default=2,
                    help="per checkpoint, dump 3D scene renders (PNG + "
                    "interactive HTML; points/GT/predictions) for the "
                    "first N val scans under <log_dir>/scene3d_eval/; "
                    "0 disables")
    ap.add_argument("--restore_model_path", default=None,
                    help="evaluate exactly this checkpoint once (run dir, "
                    "ckpt dir, or a single step dir such as best_ckpt) "
                    "instead of polling --log_dir/ckpt")
    ap.add_argument("--restore_tf_checkpoint", default=None,
                    help="not ported yet (ROADMAP Queue 1 item 13)")
    ap.add_argument("--device", default="cuda",
                    help="the device to evaluate on: cuda (default) or cpu")
    ap.add_argument("opts", nargs="*", default=[])
    args = ap.parse_args(argv)
    device = cli_device(args.device)
    if args.restore_tf_checkpoint:
        raise NotImplementedError("bin.evaluate: --restore_tf_checkpoint is not ported yet "
                                  "(ROADMAP Queue 1 item 13)")
    cfg = load_cfg(args.cfg, args.opts)
    os.makedirs(args.log_dir, exist_ok=True)
    pipeline = build_pipeline(cfg, device=device)

    def run(ckpt, step, tag):
        pipeline.model.load_state_dict(ckpt["model"])
        results, metric = evaluate_checkpoint(
            cfg, pipeline, args.split, args.cls_threshold, args.limit,
            viz_dir=os.path.join(args.log_dir, "scene3d_eval", f"ckpt_{step}"),
            viz_scans=args.viz_scans,
        )
        print(f"ckpt {step}: selection metric {metric:.2f}")
        with open(os.path.join(args.log_dir, f"eval_{tag}.json"), "w") as f:
            json.dump(results, f, indent=1)
        return metric

    if args.restore_model_path:
        ckpt, step = restore_from_path(args.restore_model_path, map_location=device)
        if ckpt is None:
            raise FileNotFoundError(f"no checkpoint under {args.restore_model_path!r}")
        print(f"evaluating checkpoint {step} from {args.restore_model_path}")
        run(ckpt, step, step if step is not None else "restored")
        return

    ckpt_mgr = CheckpointManager(os.path.join(args.log_dir, "ckpt"))
    best_metric = -1.0
    seen = set()
    while True:
        for step in [s for s in ckpt_mgr.all_steps(refresh=True) if s not in seen]:
            seen.add(step)
            ckpt, _ = ckpt_mgr.restore(step, map_location=device)
            print(f"evaluating checkpoint {step}")
            metric = run(ckpt, step, step)
            if metric > best_metric:
                best_metric = metric
                with open(os.path.join(args.log_dir, "best.json"), "w") as f:
                    json.dump({"step": step, "metric": metric}, f)
                # copy the best checkpoint aside so max-to-keep rotation
                # can't delete it (reference evaluator.py:119-128)
                src = os.path.join(ckpt_mgr.dir, str(step))
                dst = os.path.join(args.log_dir, "best_ckpt")
                if os.path.isdir(src):
                    shutil.rmtree(dst, ignore_errors=True)
                    shutil.copytree(src, dst)
                print(f"new best: {metric:.2f} @ step {step}")
        if args.once:
            break
        time.sleep(args.eval_interval_secs)


if __name__ == "__main__":
    main()
