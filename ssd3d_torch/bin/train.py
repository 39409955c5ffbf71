"""Training CLI (counterpart of `ssd3d/bin/train.py`, the reference's
lib/core/trainer.py), on the card unless `--device cpu`; on several cards
one process a card, under the SSD3D_DIST_* environment contract
(`ssd3d_torch/parallel/distributed.py`, README), with TPU.PARALLEL_MODE dp
or fsdp.

    python -m ssd3d_torch.bin.train --cfg configs/kitti/3dssd/3dssd.yaml \
        --log_dir runs/3dssd [--device cpu] [KEY VALUE ...]

PointRCNN trains stage-wise: the RPN, then the RCNN warm-started from it
with the RPN frozen:

    python -m ssd3d_torch.bin.train \
        --cfg configs/kitti/pointrcnn/pointrcnn_stage1.yaml --log_dir runs/rcnn1
    python -m ssd3d_torch.bin.train \
        --cfg configs/kitti/pointrcnn/pointrcnn_stage2.yaml --log_dir runs/rcnn2 \
        --restore_model_path runs/rcnn1

A second run on the same `--log_dir` resumes from its latest checkpoint,
batch-exact.
"""

from __future__ import annotations

import argparse

from ssd3d_torch.bin import cli_device
from ssd3d_torch.config import load_cfg
from ssd3d_torch.train.trainer import Trainer


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser(prog="python -m ssd3d_torch.bin.train")
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--log_dir", default="runs/default")
    ap.add_argument("--split", default="train")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max_iterations", type=int, default=None)
    ap.add_argument("--restore_model_path", default=None,
                    help="warm-start weights from another run dir (or its "
                    "ckpt dir, or one step dir): name-intersect transfer "
                    "restore, as the reference trainer's flag of the same name")
    ap.add_argument("--restore_tf_checkpoint", default=None,
                    help="not ported yet (ROADMAP Queue 1 item 13)")
    ap.add_argument("--device", default="cuda",
                    help="the device to train on: cuda (default) or cpu")
    ap.add_argument("opts", nargs="*", default=[])
    args = ap.parse_args(argv)
    device = cli_device(args.device)
    cfg = load_cfg(args.cfg, args.opts)
    return Trainer(cfg, args.log_dir, args.split, args.seed,
                   restore_model_path=args.restore_model_path,
                   restore_tf_checkpoint=args.restore_tf_checkpoint,
                   device=device).train(args.max_iterations)


if __name__ == "__main__":
    main()
