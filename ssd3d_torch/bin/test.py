"""One-shot inference + prediction dump (counterpart of `ssd3d/bin/test.py`,
the reference's lib/core/tester.py), on one device: the card unless
`--device cpu`. KITTI configs write per-scan result txts; nuScenes configs
write one submission-style JSON, `<log_dir>/nuscenes_result.json`
(`eval/nuscenes_predictions.py`).

    python -m ssd3d_torch.bin.test --cfg <yaml> --log_dir runs/3dssd \
        [--split val] [--cls_threshold 0.3] [--device cpu]

KITTI test-server submissions (reference tester.py:21,27 `--split test
--no_gt`): preprocess with `--img_list test`, then

    python -m ssd3d_torch.bin.test --cfg <yaml> --log_dir runs/3dssd \
        --split test --no_gt [--restore_model_path runs/3dssd/best_ckpt]
"""

from __future__ import annotations

import argparse
import os

from ssd3d_torch.bin import cli_device
from ssd3d_torch.config import load_cfg
from ssd3d_torch.data import build_loader
from ssd3d_torch.data.kitti_io import KittiScene
from ssd3d_torch.eval import nuscenes_predictions as nusc
from ssd3d_torch.eval.predictions import run_inference_on_split
from ssd3d_torch.models.api import build_pipeline
from ssd3d_torch.train.trainer import CheckpointManager, restore_from_path


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser(prog="python -m ssd3d_torch.bin.test")
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--log_dir", required=True)
    ap.add_argument("--split", default="val")
    ap.add_argument("--cls_threshold", type=float, default=0.3)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--no_gt", action="store_true",
                    help="split has no label files (KITTI test set); "
                    "implied by --split test")
    ap.add_argument("--restore_model_path", default=None,
                    help="checkpoint to load (run dir, ckpt dir, or a "
                    "single step dir such as best_ckpt); defaults to the "
                    "latest under --log_dir/ckpt")
    ap.add_argument("--device", default="cuda",
                    help="the device to run on: cuda (default) or cpu")
    ap.add_argument("opts", nargs="*", default=[])
    args = ap.parse_args(argv)
    device = cli_device(args.device)
    cfg = load_cfg(args.cfg, args.opts)
    pipeline = build_pipeline(cfg, device=device)
    loader = build_loader(cfg, args.split, training=False)
    if args.restore_model_path:
        ckpt, step = restore_from_path(args.restore_model_path, map_location=device)
    else:
        ckpt, step = CheckpointManager(os.path.join(args.log_dir, "ckpt")).restore(
            map_location=device)
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoint under {args.log_dir}/ckpt")
    pipeline.model.load_state_dict(ckpt["model"])
    print(f"restored step {step}")

    if cfg.DATASET.TYPE.upper() == "NUSCENES":
        save_path = os.path.join(args.log_dir, "nuscenes_result.json")
        nusc.run_inference_on_split(
            cfg, pipeline, loader, cls_thresh=args.cls_threshold, save_path=save_path,
            limit=args.limit, batch_size=cfg.TEST.BATCH_SIZE)
        print(f"predictions saved to {save_path}")
        return

    # the KITTI test set lives under <root>/testing and has no labels
    # (reference tester.py --split/--no_gt)
    scene_split = "testing" if args.split == "test" else "training"
    with_gt = not (args.no_gt or args.split == "test")
    scene = KittiScene(cfg.DATASET.KITTI.BASE_DIR_PATH, scene_split)
    save_dir = os.path.join(args.log_dir, "kitti_result")
    run_inference_on_split(
        cfg, pipeline, loader, scene, cls_thresh=args.cls_threshold,
        save_dir=save_dir, limit=args.limit, with_gt=with_gt,
        batch_size=cfg.TEST.BATCH_SIZE,
    )
    print(f"predictions saved to {save_dir}")


if __name__ == "__main__":
    main()
