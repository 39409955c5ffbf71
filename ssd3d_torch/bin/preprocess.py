"""Offline preprocessing CLI (counterpart of `ssd3d/bin/preprocess.py`, the
reference's lib/core/data_preprocessor.py): KITTI scans to npz splits and
the mixup database, or a raw nuScenes tree (the JSON tables and LIDAR_TOP
.pcd.bin files under DATASET.NUSCENES.BASE_DIR_PATH) to one npz per key
frame of 10 aggregated sweeps, train and val.

    python -m ssd3d_torch.bin.preprocess --cfg configs/kitti/3dssd/3dssd.yaml \
        --img_list train [--limit N] [--device cpu] [KEY VALUE ...]
    python -m ssd3d_torch.bin.preprocess --cfg configs/nuscenes/3dssd/3dssd.yaml \
        [--device cpu] [KEY VALUE ...]

Preprocessing runs on the host. `--device` is checked as every CLI of the
port checks it (the card by default; without one it raises), so a chain of
commands fails at its first step where the card it asks for is missing.
"""

from __future__ import annotations

import argparse

from ssd3d_torch.bin import cli_device
from ssd3d_torch.config import load_cfg
from ssd3d_torch.data.nuscenes import convert_raw_nuscenes
from ssd3d_torch.data.preprocess import run_preprocess


def main(argv: list[str] | None = None) -> list:
    ap = argparse.ArgumentParser(prog="python -m ssd3d_torch.bin.preprocess")
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--img_list", default="train",
                    choices=["train", "val", "trainval", "test"])
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("opts", nargs="*", default=[])
    args = ap.parse_args(argv)
    cli_device(args.device)
    cfg = load_cfg(args.cfg, args.opts)
    if cfg.DATASET.TYPE.upper() == "NUSCENES":
        # the raw tables of every split at once (the converter's own split
        # rule); --img_list and --limit are KITTI's
        ncfg = cfg.DATASET.NUSCENES
        return convert_raw_nuscenes(
            ncfg.VERSION, ncfg.BASE_DIR_PATH, ncfg.SAVE_NUMPY_PATH, nsweeps=ncfg.NSWEEPS,
            feature_channels=ncfg.INPUT_FEATURE_CHANNEL,
            val_scenes=ncfg.VAL_SCENE_LIST or None)
    if args.img_list in ("val", "test"):
        cfg.TRAIN.AUGMENTATIONS.MIXUP.OPEN = False
    return run_preprocess(cfg, args.img_list, limit=args.limit)


if __name__ == "__main__":
    main()
